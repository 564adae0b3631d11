"""Single-level tile rasterizer: binning, the Hopper kernel's wrapper and its
plain version (counterpart of the single-level half of
``stylerenderer_tpu/ops/rasterize_pallas.py``).

One binning and one kernel pass produce the ``[B, H, W]`` winner map of an
image of any size, bit-equal to the dense oracle
``ops/rasterize.py::rasterize_winners``.

- ``build_bins``: the plain version of the binning, plain torch (sort,
  ``searchsorted``, a gather) as the JAX package leaves binning to XLA; the
  tests' and ``chip_smoke.py``'s reference, not on any path.
- ``launch_bin_single``: the binning on the card, hand-written CUDA passes
  (``csrc/rasterize_single.cu``, per-triangle code in
  ``csrc/bin_single.cuh``).
- ``rasterize_winners_single``: the wrapper. A CUDA tensor goes to
  ``launch_bin_single`` and the kernel (``launch_rasterize_single``); a CPU
  tensor goes to the plain version.
- ``rasterize_winners_single_ref``: the plain version, the dense search.
- ``bin_single_host``, ``rasterize_bins_single_host``,
  ``rasterize_winners_single_host``: the card's binning and kernel built
  for the host (``csrc/rasterize_single_host.cpp``), for the CPU tests.
"""

from __future__ import annotations

import ctypes

import torch

from stylerenderer_tpu_torch.ops.rasterize import rasterize_winners
from stylerenderer_tpu_torch.ops.rasterize_multi import _setup, row_words

TILE = 8
TIER_SPANS = (1, 2, 4, 16)  # in tiles; XL = anything bigger, scanned by every tile
N_TIERS = len(TIER_SPANS) + 1


def tile_for(h: int, w: int) -> int:
    """The tile edge for an ``h x w`` image (``rasterize_pallas.py:65``):
    8 px up to 256 px, 16 up to 512, 32 beyond."""
    m = max(h, w)
    if m <= 256:
        return TILE
    if m <= 512:
        return 16
    return 32


def card_tile(h: int, w: int) -> int:
    """The card path's tile edge for an ``h x w`` image: 16 px up to 256 px,
    32 beyond, the kernel's fastest at 256 and 512 px on the H100
    (``chip_smoke.py`` times tiles 8, 16 and 32; ``PERF.md``). Winners do
    not depend on the tile; ``tile_for`` is JAX's rule."""
    return 16 if max(h, w) <= 256 else 32


def _grid(h: int, w: int, tile: int) -> tuple[int, int]:
    """Tiles across and down; an edge tile may stick out of the image."""
    return -(-w // tile), -(-h // tile)


@torch.no_grad()
def build_bins(v, tri, h: int, w: int, perspective: bool, eps: float, tile: int):
    """Sort the triangles by ``tier * ntiles + home`` -> (dat ``[B, nf, 9]``
    f32, ids ``[B, nf]`` i32, starts ``[B, 5*ntiles+1]`` i32).

    As in the JAX package (``rasterize_pallas.py:76-144``):

    - validity (front-facing, in front of the camera, valid vertex ids, a
      non-empty clamped bbox) comes from ``_setup``;
    - home is the tile of the clamped integer bbox's top-left pixel, the
      tier the smallest of ``TIER_SPANS`` that holds the bbox in tiles;
    - triangles with ``|det| <= eps`` go to XL, as do the bigger ones;
      invalid ones are sorted past ``starts[5*ntiles]`` and never read.

    ``dat`` rows hold the corner px, py, z. The sort is stable (``lax.sort``
    is not); ties break by id in the kernel, so the result cannot change.
    The tile grid rounds up (``_grid``), where the JAX package asks for
    multiples of the tile.
    """
    v = v.detach().float()
    tri = torch.as_tensor(tri, device=v.device).long()
    B, nf = v.shape[0], tri.shape[0]
    ntx, nty = _grid(h, w, tile)
    ntiles = ntx * nty

    px, py, z, _, _, _, valid, _ = _setup(v, tri, h, w, perspective, eps)
    # the clamped integer bbox; clamping the far ends as well changes no
    # valid triangle and keeps the int conversion defined for invalid ones
    x0 = torch.clamp(torch.ceil(px.amin(-1)), 0.0, w - 1.0).int()
    x1 = torch.clamp(torch.floor(px.amax(-1)), 0.0, w - 1.0).int()
    y0 = torch.clamp(torch.ceil(py.amin(-1)), 0.0, h - 1.0).int()
    y1 = torch.clamp(torch.floor(py.amax(-1)), 0.0, h - 1.0).int()
    tx0, tx1 = x0 // tile, x1 // tile
    ty0, ty1 = y0 // tile, y1 // tile
    ts = torch.maximum(tx1 - tx0, ty1 - ty0) + 1

    xl = N_TIERS - 1
    tier = torch.full_like(ts, xl)
    for k in range(xl - 1, -1, -1):
        tier = torch.where(ts <= TIER_SPANS[k], k, tier)
    px0, px1, px2 = px.unbind(-1)
    py0, py1, py2 = py.unbind(-1)
    det = (px1 * py2 - py1 * px2) + (py0 * px2 - px0 * py2) + (px0 * py1 - py0 * px1)
    sgn = torch.where(det < 0, -1.0, 1.0).to(det.dtype)
    tier = torch.where(det * sgn <= eps, xl, tier)
    home = ty0 * ntx + tx0
    key = torch.where(valid, tier * ntiles + home, N_TIERS * ntiles)

    key_sorted, perm = torch.sort(key, dim=-1, stable=True)
    bounds = torch.arange(N_TIERS * ntiles + 1, device=v.device,
                          dtype=key_sorted.dtype).expand(B, -1).contiguous()
    starts = torch.searchsorted(key_sorted.contiguous(), bounds).int()
    feat = torch.cat([px, py, z], dim=-1)  # [B, nf, 9]
    dat = torch.gather(feat, 1, perm[..., None].expand(B, nf, 9))
    return dat.contiguous(), perm.int().contiguous(), starts.contiguous()


ROW_WORDS = row_words(0)  # 9 corner floats, the id's bits, padding: 48 bytes


def _check_args(v, h: int, w: int, tile: int | None) -> int:
    """Validate the call -> the tile (``card_tile`` when None)."""
    if v.ndim != 3 or v.shape[-1] != 3:
        raise ValueError(f"v must be [B, nv, 3], got {tuple(v.shape)}")
    if h < 1 or w < 1:
        raise ValueError(f"image {h} x {w} is empty")
    tile = card_tile(h, w) if tile is None else tile
    if not 1 <= tile <= 32:
        raise ValueError(f"tile {tile}: the kernel takes 1 to 32 px")
    return tile


def _bin_args(v, tri):
    """The binning's inputs as its passes read them -> (v f32, tri i64),
    contiguous on ``v``'s device."""
    v = v.detach().float().contiguous()
    tri = torch.as_tensor(tri, device=v.device).long().contiguous()
    if tri.ndim != 2 or tri.shape[-1] != 3:
        raise ValueError(f"tri must be [nf, 3], got {tuple(tri.shape)}")
    return v, tri


def _n_keys(h: int, w: int, tile: int) -> int:
    ntx, nty = _grid(h, w, tile)
    return N_TIERS * ntx * nty


def launch_bin_single(v, tri, h: int, w: int, perspective: bool, eps: float, tile: int):
    """Bin on the card with the hand-written passes of
    ``csrc/rasterize_single.cu`` (a zeroed count buffer, then classify, scan
    and scatter: four launches, no host synchronisation, no sort) -> (rows
    ``[B, nf, 12]`` f32, starts ``[B, 5*ntiles+1]`` i32, keys ``[B, nf]``
    i32).

    The keys and ``starts`` are ``build_bins``'; row ``p`` holds what its
    ``dat[:, p]`` holds, then the id's bits at column 9, for the valid
    prefix ``[0, starts[:, -1])`` only. The order within a segment varies
    from run to run, which the kernel's result does not depend on."""
    from stylerenderer_tpu_torch.ops._build import library

    if v.device.type != "cuda":
        raise ValueError(f"the card's binning takes CUDA tensors, got {v.device}")
    tile = _check_args(v, h, w, tile)
    v, tri = _bin_args(v, tri)
    B, nv, _ = v.shape
    nf = tri.shape[0]
    K = _n_keys(h, w, tile)
    counts = torch.zeros((B, K), dtype=torch.int32, device=v.device)
    rank = torch.empty((B, nf), dtype=torch.int32, device=v.device)
    keys = torch.empty((B, nf), dtype=torch.int32, device=v.device)
    starts = torch.empty((B, K + 1), dtype=torch.int32, device=v.device)
    rows = torch.empty((B, nf, ROW_WORDS), dtype=torch.float32, device=v.device)
    lib = library("single")
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.sr_bin_single(v.data_ptr(), tri.data_ptr(), counts.data_ptr(), keys.data_ptr(),
                           rank.data_ptr(), starts.data_ptr(), rows.data_ptr(), B, nv, nf, h, w,
                           tile, int(perspective), eps, stream)
    if rc != 0:
        raise RuntimeError("bin_single launch failed: " + lib.sr_error_string(rc).decode())
    return rows, starts, keys


def _check_bins(rows, starts, h: int, w: int, tile: int, device_type: str):
    """Validate the binning's output for the kernel (or its host build)."""
    B, nf = rows.shape[:2]
    expect = ((rows, torch.float32, (B, nf, ROW_WORDS)),
              (starts, torch.int32, (B, _n_keys(h, w, tile) + 1)))
    for t, dt, shape in expect:
        if t.device.type != device_type or t.device != rows.device:
            raise ValueError(f"kernel inputs must lie on one {device_type} device, "
                             f"got {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"kernel input {t.dtype} {tuple(t.shape)} (contiguous: "
                             f"{t.is_contiguous()}), expected contiguous {dt} {shape}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned for the kernel's 16-byte loads")


def launch_rasterize_single(rows, starts, h: int, w: int, tile: int, perspective: bool,
                            eps: float):
    """Launch the Hopper kernel on the card's binning (``launch_bin_single``)
    on the current stream -> winners ``[B, H, W]`` i32. Counts the launch in
    ``rasterize_winners_single.launches``; raises when the launch is
    refused."""
    from stylerenderer_tpu_torch.ops._build import library

    _check_bins(rows, starts, h, w, tile, "cuda")
    lib = library("single")
    B = rows.shape[0]
    wins = torch.empty((B, h, w), dtype=torch.int32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = lib.sr_rasterize_single(rows.data_ptr(), starts.data_ptr(), wins.data_ptr(), B,
                                 rows.shape[1], h, w, tile, int(perspective), eps, stream)
    if rc != 0:
        raise RuntimeError("rasterize_single launch failed: "
                           + lib.sr_error_string(rc).decode())
    rasterize_winners_single.launches += 1
    return wins


# the plain version of the kernel: the dense search, the oracle of the
# bit-exact contract (winners do not depend on the tile)
rasterize_winners_single_ref = rasterize_winners


def rasterize_winners_single(v, tri, h: int, w: int, perspective: bool = False,
                             eps: float = 1e-6, tile: int | None = None):
    """Winner map ``[B, H, W]`` int32 (-1 background) of ``v`` ``[B, nv, 3]``.

    A CUDA ``v`` is binned on the card (``launch_bin_single``) and launches
    the kernel (counted in ``rasterize_winners_single.launches``); a CPU
    ``v`` takes the plain version. There is no fallback between the two.
    """
    tile = _check_args(v, h, w, tile)
    if v.device.type == "cpu":
        return rasterize_winners_single_ref(v, tri, h, w, perspective, eps)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    rows, starts, _ = launch_bin_single(v, tri, h, w, perspective, eps, tile)
    return launch_rasterize_single(rows, starts, h, w, tile, perspective, eps)


rasterize_winners_single.launches = 0


def bin_single_host(v, tri, h: int, w: int, perspective: bool, eps: float, tile: int):
    """The card's binning compiled for the host (g++), on CPU tensors ->
    ``launch_bin_single``'s (rows, starts, keys); each segment in ascending
    id order."""
    from stylerenderer_tpu_torch.ops._build import library

    tile = _check_args(v, h, w, tile)
    v, tri = _bin_args(v.cpu(), tri)
    B, nv, _ = v.shape
    nf = tri.shape[0]
    K = _n_keys(h, w, tile)
    keys = torch.empty((B, nf), dtype=torch.int32)
    starts = torch.empty((B, K + 1), dtype=torch.int32)
    rows = torch.empty((B, nf, ROW_WORDS), dtype=torch.float32)
    rc = library("single_host").sr_bin_single_host(
        v.data_ptr(), tri.data_ptr(), keys.data_ptr(), starts.data_ptr(), rows.data_ptr(), B, nv,
        nf, h, w, tile, int(perspective), ctypes.c_float(eps))
    if rc != 0:
        raise RuntimeError("host bin_single rejected its arguments")
    return rows, starts, keys


def rasterize_bins_single_host(rows, starts, h: int, w: int, tile: int,
                               perspective: bool = False, eps: float = 1e-6,
                               round_size: int = 0):
    """The kernel's per-tile schedule and candidate math compiled for the
    host (g++) on binned rows (``bin_single_host``) -> winners ``[B, H,
    W]``, as the kernel. ``round_size`` candidates per round (0: the
    kernel's block for the tile; below 32, or a multiple of 32)."""
    from stylerenderer_tpu_torch.ops._build import library

    _check_bins(rows, starts, h, w, tile, "cpu")
    B = rows.shape[0]
    wins = torch.empty((B, h, w), dtype=torch.int32)
    rc = library("single_host").sr_rasterize_single_host(
        rows.data_ptr(), starts.data_ptr(), wins.data_ptr(), B, rows.shape[1], h, w, tile,
        round_size, int(perspective), ctypes.c_float(eps))
    if rc != 0:
        raise RuntimeError("host rasterize_single rejected its arguments")
    return wins


def rasterize_winners_single_host(v, tri, h: int, w: int, perspective: bool = False,
                                  eps: float = 1e-6, tile: int | None = None,
                                  round_size: int = 0):
    """The card's binning and kernel compiled for the host (g++), on CPU
    tensors: the same output as ``rasterize_winners_single`` on the card."""
    tile = _check_args(v, h, w, tile)
    rows, starts, _ = bin_single_host(v, tri, h, w, perspective, eps, tile)
    return rasterize_bins_single_host(rows, starts, h, w, tile, perspective, eps, round_size)
