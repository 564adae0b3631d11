"""Single-level tile rasterizer: binning, the Hopper kernel's wrapper and its
plain version (counterpart of the single-level half of
``stylerenderer_tpu/ops/rasterize_pallas.py``).

One binning and one kernel pass produce the ``[B, H, W]`` winner map of an
image of any size, bit-equal to the dense oracle
``ops/rasterize.py::rasterize_winners``.

- ``build_bins``: plain torch on the tensor's device (sort,
  ``searchsorted``, a gather), as the JAX package leaves binning to XLA.
- ``rasterize_winners_single``: the wrapper. A CUDA tensor goes to the kernel
  (``csrc/rasterize_single.cu``, launched by ``launch_rasterize_single``); a
  CPU tensor goes to the plain version.
- ``rasterize_winners_single_ref``: the plain version, the dense search.
- ``rasterize_winners_single_host``: the kernel's math built for the host
  (``csrc/rasterize_single_host.cpp``), for the CPU tests.
"""

from __future__ import annotations

import ctypes

import torch

from stylerenderer_tpu_torch.ops.rasterize import rasterize_winners
from stylerenderer_tpu_torch.ops.rasterize_multi import _setup

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


def _check_args(v, h: int, w: int, tile: int | None) -> int:
    """Validate the call -> the tile (``tile_for`` when None)."""
    if v.ndim != 3 or v.shape[-1] != 3:
        raise ValueError(f"v must be [B, nv, 3], got {tuple(v.shape)}")
    if h < 1 or w < 1:
        raise ValueError(f"image {h} x {w} is empty")
    tile = tile_for(h, w) if tile is None else tile
    if not 1 <= tile <= 32:
        raise ValueError(f"tile {tile}: the kernel takes 1 to 32 px")
    return tile


def _check_bins(dat, ids, starts, h: int, w: int, tile: int):
    """Validate ``build_bins``' output for the kernel."""
    B, nf, _ = dat.shape
    ntx, nty = _grid(h, w, tile)
    expect = ((dat, torch.float32, (B, nf, 9)), (ids, torch.int32, (B, nf)),
              (starts, torch.int32, (B, N_TIERS * ntx * nty + 1)))
    for t, dt, shape in expect:
        if t.device.type != "cuda" or t.device != dat.device:
            raise ValueError(f"kernel inputs must lie on one CUDA device, got {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"kernel input {t.dtype} {tuple(t.shape)} (contiguous: "
                             f"{t.is_contiguous()}), expected contiguous {dt} {shape}")


def launch_rasterize_single(dat, ids, starts, h: int, w: int, tile: int,
                            perspective: bool, eps: float):
    """Launch the Hopper kernel on binned triangles (``build_bins``) on the
    current stream -> winners ``[B, H, W]`` i32. Counts the launch in
    ``rasterize_winners_single.launches``; raises when the launch is
    refused."""
    from stylerenderer_tpu_torch.ops._build import library

    _check_bins(dat, ids, starts, h, w, tile)
    lib = library("single")
    B = dat.shape[0]
    wins = torch.empty((B, h, w), dtype=torch.int32, device=dat.device)
    stream = torch.cuda.current_stream(dat.device).cuda_stream
    rc = lib.sr_rasterize_single(dat.data_ptr(), ids.data_ptr(), starts.data_ptr(),
                                 wins.data_ptr(), B, dat.shape[1], h, w, tile,
                                 int(perspective), eps, stream)
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

    A CUDA ``v`` launches the kernel (and counts the launch in
    ``rasterize_winners_single.launches``); a CPU ``v`` takes the plain
    version. There is no fallback between the two.
    """
    tile = _check_args(v, h, w, tile)
    if v.device.type == "cpu":
        return rasterize_winners_single_ref(v, tri, h, w, perspective, eps)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    dat, ids, starts = build_bins(v, tri, h, w, perspective, eps, tile)
    return launch_rasterize_single(dat, ids, starts, h, w, tile, perspective, eps)


rasterize_winners_single.launches = 0


def rasterize_winners_single_host(v, tri, h: int, w: int, perspective: bool = False,
                                  eps: float = 1e-6, tile: int | None = None):
    """The kernel's candidate math and tile worklists compiled for the host
    (g++), on CPU tensors: same binning, same output as the kernel."""
    from stylerenderer_tpu_torch.ops._build import library

    tile = _check_args(v, h, w, tile)
    lib = library("single_host")
    dat, ids, starts = build_bins(v.cpu(), tri, h, w, perspective, eps, tile)
    B = dat.shape[0]
    wins = torch.empty((B, h, w), dtype=torch.int32)
    rc = lib.sr_rasterize_single_host(dat.data_ptr(), ids.data_ptr(), starts.data_ptr(),
                                      wins.data_ptr(), B, dat.shape[1], h, w, tile,
                                      int(perspective), ctypes.c_float(eps))
    if rc != 0:
        raise RuntimeError("host rasterize_single rejected its arguments")
    return wins
