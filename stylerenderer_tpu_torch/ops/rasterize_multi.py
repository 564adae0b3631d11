"""Multi-level pyramid rasterizer: binning, the Hopper kernel's wrapper and
its plain version (counterpart of the multi-level half of
``stylerenderer_tpu/ops/rasterize_pallas.py``).

One binning and one kernel pass produce the winner maps (and, with
``attrs``, the interpolated attribute maps) of every pyramid level ``top,
top/2, ..., top >> (n_levels-1)``, each bit-equal to the dense oracle
``ops/rasterize.py::rasterize_winners`` at that size.

- ``build_bins_multi``: the plain version of the binning, plain torch
  (sort, ``searchsorted``, gathers) as the JAX package leaves binning to
  XLA; the tests' and ``chip_smoke.py``'s reference, not on any path.
- ``launch_bin_multi``: the binning on the card, hand-written CUDA passes
  (``csrc/rasterize_multi.cu``, per-triangle code in ``csrc/bin_multi.cuh``).
- ``rasterize_winners_multi``: the wrapper. A CUDA tensor goes to
  ``launch_bin_multi`` and the kernel (``launch_rasterize_multi``); a CPU
  tensor goes to the plain version.
- ``rasterize_winners_multi_ref``: the plain version, dense search per
  level then ``_interp_from_win``.
- ``bin_multi_host``, ``rasterize_bins_multi_host``,
  ``rasterize_winners_multi_host``: the card's binning and kernel built for
  the host (``csrc/rasterize_multi_host.cpp``), for the CPU tests.

Each takes a ``band``: top-level tile rows ``(ty0, nty)``, the rows
``[ty0, ty0 + nty)`` of the tile grid (``None``: the whole image). Level
``k`` then gives its rows ``[ty0 * tile >> k, (ty0 + nty) * tile >> k)``,
``[B, (nty * tile) >> k, s]``, bit-equal to those rows of the whole
image's result; the binning keeps only the triangles whose tile rows meet
the band and the kernel's grid covers only the band's tiles. Every level's
band must be whole rows, so a band of ``r`` top-level rows needs a tile
that divides ``r``: ``space_band`` picks ``default_tile(top)`` or, for
narrower bands, the band's own height (a 256 px pyramid split over 2 or 4
ranks has 128- or 64-row bands and keeps tile 16; the 16 px GAR over 4
ranks has 4-row bands and takes tile 4). That is the spatial sharding of
``parallel/spatial.py``: each rank renders its band of every level.
"""

from __future__ import annotations

import ctypes

import torch

from stylerenderer_tpu_torch.ops.rasterize import (
    _interp_from_win,
    _project_verts,
    _triangle_table,
    default_tile,
    rasterize_winners,
)

# (tier, span, full candidate math) — spans above 2 go to XL (tier 3)
MULTI_TIERS = (
    (0, 1, False),  # fast span-1: the vast majority of a dense face mesh
    (1, 2, False),  # fast span-2
    (2, 2, True),   # degenerate at some level, span <= 2
)
MULTI_N_TIERS = len(MULTI_TIERS) + 1  # + XL, scanned by every tile


def _setup(v, tri, h: int, w: int, perspective: bool, eps: float):
    """Per-triangle projected verts, validity and clamped integer bbox
    (own copy of ``rasterize_binned.py:38::_setup``, batched over ``v``
    ``[B, nv, 3]``): returns px, py, z ``[B, nf, 3]``, persp_ok, x0, y0,
    valid and span ``[B, nf]``."""
    nv = v.shape[1]
    idx_ok = torch.all((tri >= 0) & (tri < nv), dim=-1)
    pts = v[:, tri.clamp(0, nv - 1).reshape(-1), :].reshape(
        v.shape[0], tri.shape[0], 3, 3)
    px, py, z, persp_ok = _project_verts(pts, h, w, perspective, eps)
    x0 = torch.clamp(torch.ceil(px.amin(-1)), min=0.0)
    x1 = torch.clamp(torch.floor(px.amax(-1)), max=w - 1.0)
    y0 = torch.clamp(torch.ceil(py.amin(-1)), min=0.0)
    y1 = torch.clamp(torch.floor(py.amax(-1)), max=h - 1.0)
    bbox_ok = (x1 >= x0) & (y1 >= y0)
    px0, px1, px2 = px.unbind(-1)
    py0, py1, py2 = py.unbind(-1)
    det = px1 * py2 - py1 * px2 + py0 * px2 - px0 * py2 + px0 * py1 - py0 * px1
    valid = idx_ok & persp_ok & bbox_ok & (det <= eps)
    span = torch.where(valid, torch.maximum(x1 - x0, y1 - y0) + 1.0,
                       torch.zeros_like(x0))
    return px, py, z, persp_ok, x0, y0, valid, span


def _sparse_sp(top: int, wl: int, tile: int) -> tuple[int, int]:
    """Owning-tile stride and phase of a sparse level (pixels larger than a
    tile): level pixel ``p`` has its center in tile ``p*S + phase``."""
    ntx = top // tile
    if ntx & (ntx - 1):
        raise ValueError(f"top/tile = {ntx} must be a power of two")
    step = top // wl
    return step // tile, (step // 2 - 1) // tile


@torch.no_grad()
def build_bins_multi(v, tri, top: int, n_levels: int, perspective: bool,
                     eps: float, tile: int, attrs=None, band=None):
    """Sort the triangles by ``tier * ntiles + home`` for the multi-level
    kernel -> (dat ``[B, nf, 9+3C]`` f32, ids ``[B, nf]`` i32, starts
    ``[B, 4*ntiles+1]`` i32).

    ``dat`` rows hold the corner px, py, z at the top level, then the
    per-corner attributes (corner-major, channel-minor). As in the JAX
    package (``rasterize_pallas.py:645``):

    - validity is the union over levels, so a sliver that covers only a
      coarse pixel center is kept;
    - a triangle degenerate at ANY level (``|det| <= eps * 4**kmax``, det
      shrinks by 4 per level) goes to the degenerate tier or XL;
    - home is the top-left tile of the float bbox (floor, not ceil);
    - with a ``band``, a triangle whose tile rows miss it is invalid.

    The sort is stable (``lax.sort`` is not); ties break by id in the
    kernel, so the result cannot change.
    """
    v = v.detach().float()
    tri = torch.as_tensor(tri, device=v.device).long()
    B, nv, _ = v.shape
    nf = tri.shape[0]
    ntx = top // tile
    ntiles = ntx * ntx
    kmax = n_levels - 1
    band_lo, nty = _check_band(top, n_levels, tile, band)
    det_scale = float(4 ** kmax)

    px, py, z, persp_ok, *_ = _setup(v, tri, top, top, perspective, eps)
    umin, umax = px.amin(-1), px.amax(-1)
    vmin, vmax = py.amin(-1), py.amax(-1)

    bbox_any = torch.zeros_like(persp_ok)
    for k in range(n_levels):
        inv = 1.0 / (1 << k)
        wl = top >> k
        u0 = (umin + 0.5) * inv - 0.5
        u1 = (umax + 0.5) * inv - 0.5
        v0 = (vmin + 0.5) * inv - 0.5
        v1 = (vmax + 0.5) * inv - 0.5
        ok = ((torch.clamp(torch.floor(u1), max=wl - 1.0)
               >= torch.clamp(torch.ceil(u0), min=0.0))
              & (torch.clamp(torch.floor(v1), max=wl - 1.0)
                 >= torch.clamp(torch.ceil(v0), min=0.0)))
        bbox_any = bbox_any | ok
    idx_ok = torch.all((tri >= 0) & (tri < nv), dim=-1)

    px0, px1, px2 = px.unbind(-1)
    py0, py1, py2 = py.unbind(-1)
    det = (px1 * py2 - py1 * px2) + (py0 * px2 - px0 * py2) + (px0 * py1 - py0 * px1)
    valid = idx_ok & persp_ok & bbox_any & (det <= eps * det_scale)

    # float-bbox tile extent; clamping both ends changes no valid triangle
    # and keeps the int conversion defined for off-screen ones
    x0 = torch.clamp(torch.floor(umin), 0.0, top - 1.0).int()
    x1 = torch.clamp(torch.floor(umax), 0.0, top - 1.0).int()
    y0 = torch.clamp(torch.floor(vmin), 0.0, top - 1.0).int()
    y1 = torch.clamp(torch.floor(vmax), 0.0, top - 1.0).int()
    x1 = torch.maximum(x1, x0)
    y1 = torch.maximum(y1, y0)
    tx0, tx1 = x0 // tile, x1 // tile
    ty0, ty1 = y0 // tile, y1 // tile
    ts = torch.maximum(tx1 - tx0, ty1 - ty0) + 1

    xl = MULTI_N_TIERS - 1
    sgn = torch.where(det < 0, -1.0, 1.0).to(det.dtype)
    deg = det * sgn <= eps * det_scale
    tier = torch.where(ts <= 1, 0, torch.where(ts <= 2, 1, xl))
    tier = torch.where(deg, torch.where(ts <= 2, 2, xl), tier)
    home = ty0 * ntx + tx0
    valid = valid & (ty1 >= band_lo) & (ty0 < band_lo + nty)
    key = torch.where(valid, tier * ntiles + home, MULTI_N_TIERS * ntiles)

    key_sorted, perm = torch.sort(key, dim=-1, stable=True)
    bounds = torch.arange(MULTI_N_TIERS * ntiles + 1, device=v.device,
                          dtype=key_sorted.dtype).expand(B, -1).contiguous()
    starts = torch.searchsorted(key_sorted.contiguous(), bounds).int()

    feats = [px, py, z]
    if attrs is not None:
        ab = attrs.detach().float()
        tri_safe = tri.clamp(0, nv - 1)
        feats += [ab[:, tri_safe[:, k], :] for k in range(3)]
    feat = torch.cat(feats, dim=-1)  # [B, nf, 9 + 3C]
    R = feat.shape[-1]
    dat = torch.gather(feat, 1, perm[..., None].expand(B, nf, R)).contiguous()
    return dat, perm.int().contiguous(), starts.contiguous()


def _check_levels(top: int, n_levels: int, tile: int | None) -> int:
    """Validate the pyramid layout -> the tile (``default_tile`` when None)."""
    if tile is None:
        tile = default_tile(top)
    if top % tile or n_levels < 1 or top >> (n_levels - 1) < 1:
        raise ValueError(f"top {top}, {n_levels} levels, tile {tile}: top must be a "
                         "multiple of the tile and every level at least 1 px")
    for k in range(n_levels):
        if not tile >> k:
            _sparse_sp(top, top >> k, tile)
    return tile


def _check_band(top: int, n_levels: int, tile: int, band) -> tuple[int, int]:
    """Validate a band of top-level tile rows -> ``(ty0, nty)`` (``None``:
    the whole image, ``(0, top // tile)``). Raises unless it lies in the
    tile grid and is whole rows at every level."""
    ntx = top // tile
    if band is None:
        return 0, ntx
    ty0, nty = (int(b) for b in band)
    if ty0 < 0 or nty < 1 or ty0 + nty > ntx:
        raise ValueError(f"band of tile rows [{ty0}, {ty0 + nty}) outside the {ntx} rows of "
                         f"{tile} px tiles at top {top}")
    for k in range(n_levels):
        if (ty0 * tile) % (1 << k) or (nty * tile) % (1 << k):
            raise ValueError(f"band of tile rows [{ty0}, {ty0 + nty}) (tile {tile}) is not "
                             f"whole rows at the {top >> k} px level")
    return ty0, nty


def band_level_rows(top: int, tile: int, band, k: int) -> tuple[int, int]:
    """Level ``k``'s rows ``[y0, y1)`` of a band of tile rows (``None``:
    all of them)."""
    ty0, nty = (0, top // tile) if band is None else band
    return (ty0 * tile) >> k, ((ty0 + nty) * tile) >> k


def space_band(top: int, n_levels: int, n_space: int, index: int, tile: int | None = None):
    """The tile and the band of tile rows of part ``index`` of ``n_space``
    equal row bands of a ``top``-px pyramid of ``n_levels`` levels ->
    ``(tile, (ty0, nty))``. ``tile`` (default ``default_tile(top)``) is
    halved until it divides the band. Raises unless ``n_space`` divides
    every level's height (so the smallest level has at least ``n_space``
    rows)."""
    smallest = top >> (n_levels - 1)
    if n_space < 1 or not 0 <= index < n_space or top % n_space or smallest % n_space:
        raise ValueError(f"{n_space} row bands of a pyramid {top}..{smallest} px: every level's "
                         f"height must be a multiple of {n_space}")
    rows = top // n_space
    tile = default_tile(top) if tile is None else tile
    while rows % tile:
        tile //= 2
    tile = _check_levels(top, n_levels, tile)
    band = (index * rows // tile, rows // tile)
    _check_band(top, n_levels, tile, band)
    return tile, band


def split_levels(vals, wins, B: int, top: int, n_levels: int, n_attr: int, rows: int = 0):
    """Level-major flat outputs of a band ``rows`` top-level rows high (0:
    the whole image) -> per level (values, winners) or winners."""
    rows = rows or top
    outs = []
    off = 0
    for k in range(n_levels):
        s, h = top >> k, rows >> k
        n = B * h * s
        w = wins[off:off + n].view(B, h, s)
        if n_attr:
            outs.append((vals[off * n_attr:(off + n) * n_attr].view(B, h, s, n_attr), w))
        else:
            outs.append(w)
        off += n
    return outs


def _alloc_outputs(B, top, n_levels, n_attr, device, rows: int = 0):
    rows = rows or top
    n = sum(B * (top >> k) * (rows >> k) for k in range(n_levels))
    vals = torch.empty(max(n * n_attr, 1), dtype=torch.float32, device=device)
    wins = torch.empty(n, dtype=torch.int32, device=device)
    return vals, wins


def rasterize_winners_multi_ref(v, tri, top: int, n_levels: int,
                                perspective: bool = False, eps: float = 1e-6,
                                attrs=None, tile: int | None = None, band=None):
    """Plain version of the kernel: the dense search at every level (on the
    band's rows of it), then ``_interp_from_win`` (the oracle of the
    bit-exact contract)."""
    tile = _check_levels(top, n_levels, tile)
    _check_band(top, n_levels, tile, band)
    v = v.detach().float()
    tri = torch.as_tensor(tri, device=v.device)
    tbl = None if attrs is None else _triangle_table(v, attrs.detach().float(), tri)
    outs = []
    for k in range(n_levels):
        s = top >> k
        y0, y1 = band_level_rows(top, tile, band, k)
        win = rasterize_winners(v, tri, s, s, perspective, eps,
                                rows=None if band is None else (y0, y1))
        if attrs is None:
            outs.append(win)
        else:
            with torch.no_grad():
                vals = _interp_from_win(v, attrs.detach().float(), tri, win, s, s,
                                        perspective, eps, tbl=tbl, y0=y0)
            outs.append((vals, win))
    return outs


def _check_inputs(v, attrs):
    if v.ndim != 3 or v.shape[-1] != 3:
        raise ValueError(f"v must be [B, nv, 3], got {tuple(v.shape)}")
    if attrs is not None:
        if attrs.shape[:2] != v.shape[:2]:
            raise ValueError(f"attrs {tuple(attrs.shape)} does not match v {tuple(v.shape)}")
        if attrs.shape[-1] > 7:
            raise ValueError("fused interpolation supports at most 7 channels")
        if attrs.device != v.device:
            raise ValueError("attrs and v must be on one device")


def row_words(n_attr: int) -> int:
    """Words of one row of ``launch_bin_multi``'s output: the 9 corner
    floats, the 3C corner attributes and the id's bits, padded to a multiple
    of 16 bytes (``csrc/rasterize_multi.cuh::row_words``)."""
    return (9 + 3 * n_attr + 1 + 3) // 4 * 4


def _bin_args(v, tri, top: int, n_levels: int, tile: int, attrs):
    """The binning's inputs as its passes read them -> (v f32, tri i64,
    attrs f32 or None, K), all contiguous on ``v``'s device."""
    v = v.detach().float().contiguous()
    tri = torch.as_tensor(tri, device=v.device).long().contiguous()
    if tri.ndim != 2 or tri.shape[-1] != 3:
        raise ValueError(f"tri must be [nf, 3], got {tuple(tri.shape)}")
    if not 1 <= n_levels <= 11:
        raise ValueError(f"{n_levels} levels: the kernel takes 1 to 11")
    ab = None if attrs is None else attrs.detach().float().contiguous()
    return v, tri, ab, MULTI_N_TIERS * (top // tile) ** 2


def _bin_outputs(B: int, nf: int, K: int, n_attr: int, device):
    """(keys, starts, rows, slots) of the binning, allocated and not
    written."""
    return (torch.empty((B, nf), dtype=torch.int32, device=device),
            torch.empty((B, K + 1), dtype=torch.int32, device=device),
            torch.empty((B, nf, row_words(n_attr)), dtype=torch.float32, device=device),
            torch.empty((B, nf), dtype=torch.int32, device=device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_bin_multi(v, tri, top: int, n_levels: int, perspective: bool, eps: float,
                     tile: int, attrs=None, band=None):
    """Bin on the card with the hand-written passes of
    ``csrc/rasterize_multi.cu`` (a zeroed count buffer, then classify, scan
    and scatter: four launches, no host synchronisation, no sort) ->
    (rows ``[B, nf, row_words(C)]`` f32, starts ``[B, 4*ntiles+1]`` i32,
    slots ``[B, nf]`` i32, keys ``[B, nf]`` i32).

    The keys and ``starts`` are ``build_bins_multi``'s; row ``p`` holds what
    its ``dat[:, p]`` holds, then the id's bits at column ``9 + 3C``, for
    the valid prefix ``[0, starts[:, -1])`` only; ``slots[b, id]`` is the
    row of valid triangle ``id`` (the kernel reads its winners' values
    there). The order within a segment varies from run to run, which the
    kernel's result does not depend on. With a ``band``, only the triangles
    whose tile rows meet it are valid."""
    from stylerenderer_tpu_torch.ops._build import library

    if v.device.type != "cuda":
        raise ValueError(f"the card's binning takes CUDA tensors, got {v.device}")
    _check_inputs(v, attrs)
    ty0, nty = _check_band(top, n_levels, tile, band)
    v, tri, ab, K = _bin_args(v, tri, top, n_levels, tile, attrs)
    B, nv, _ = v.shape
    nf = tri.shape[0]
    n_attr = 0 if ab is None else ab.shape[-1]
    counts = torch.zeros((B, K), dtype=torch.int32, device=v.device)
    rank = torch.empty((B, nf), dtype=torch.int32, device=v.device)
    keys, starts, rows, slots = _bin_outputs(B, nf, K, n_attr, v.device)
    lib = library("multi")
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.sr_bin_multi(v.data_ptr(), tri.data_ptr(), _ptr(ab), counts.data_ptr(),
                          keys.data_ptr(), rank.data_ptr(), starts.data_ptr(), rows.data_ptr(),
                          slots.data_ptr(), B, nv, nf, top, n_levels, tile, n_attr,
                          int(perspective), ty0, nty, eps, stream)
    if rc != 0:
        raise RuntimeError("bin_multi launch failed: " + lib.sr_error_string(rc).decode())
    return rows, starts, slots, keys


def _check_bins(rows, starts, slots, top: int, tile: int, n_attr: int, device_type: str):
    """Validate the binning's output for the kernel (or its host build)."""
    B, nf = rows.shape[:2]
    ntiles = (top // tile) ** 2
    if not 0 <= n_attr <= 7:
        raise ValueError(f"{n_attr} attribute channels: the kernel takes 0 to 7")
    expect = ((rows, torch.float32, (B, nf, row_words(n_attr))),
              (starts, torch.int32, (B, MULTI_N_TIERS * ntiles + 1)),
              (slots, torch.int32, (B, nf)))
    for t, dt, shape in expect:
        if t.device.type != device_type or t.device != rows.device:
            raise ValueError(f"kernel inputs must lie on one {device_type} device, "
                             f"got {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"kernel input {t.dtype} {tuple(t.shape)} (contiguous: "
                             f"{t.is_contiguous()}), expected contiguous {dt} {shape}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned for the kernel's 16-byte loads")


def launch_rasterize_multi(rows, starts, slots, top: int, n_levels: int, tile: int,
                           n_attr: int, perspective: bool, eps: float, band=None):
    """Launch the Hopper kernel on the card's binning (``launch_bin_multi``,
    of the same ``band``) on the current stream, over the band's tiles ->
    flat level-major (values, winners) of the band. Counts the launch in
    ``rasterize_winners_multi.launches``, and a launch on a band narrower
    than the image also in ``rasterize_winners_multi.band_launches``;
    raises when the launch is refused."""
    from stylerenderer_tpu_torch.ops._build import library

    _check_bins(rows, starts, slots, top, tile, n_attr, "cuda")
    ty0, nty = _check_band(top, n_levels, tile, band)
    lib = library("multi")
    B = rows.shape[0]
    vals, wins = _alloc_outputs(B, top, n_levels, n_attr, rows.device, nty * tile)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = lib.sr_rasterize_multi(
        rows.data_ptr(), starts.data_ptr(), slots.data_ptr(), vals.data_ptr(), wins.data_ptr(), B,
        rows.shape[1], top, n_levels, tile, n_attr, int(perspective), ty0, nty, eps, stream)
    if rc != 0:
        raise RuntimeError("rasterize_multi launch failed: "
                           + lib.sr_error_string(rc).decode())
    rasterize_winners_multi.launches += 1
    if nty * tile < top:
        rasterize_winners_multi.band_launches += 1
    return vals, wins


def rasterize_winners_multi(v, tri, top: int, n_levels: int,
                            perspective: bool = False, eps: float = 1e-6,
                            attrs=None, tile: int | None = None, band=None):
    """Winner maps, or fused value maps, of the whole pyramid in one pass.

    ``attrs=None``: a list of ``n_levels`` winner maps ``[B, s, s]`` int32
    (-1 background), ``s = top >> k``. ``attrs`` ``[B, nv, C]`` (C <= 7): a
    list of ``(values [B, s, s, C] f32, winners [B, s, s] i32)``, values 0
    on background. With a ``band`` of tile rows, each level's rows of it
    (see the module's docstring).

    A CUDA ``v`` is binned on the card (``launch_bin_multi``) and launches
    the kernel (counted in ``rasterize_winners_multi.launches``); a CPU
    ``v`` takes the plain version. There is no fallback between the two.
    """
    tile = _check_levels(top, n_levels, tile)
    _, nty = _check_band(top, n_levels, tile, band)
    _check_inputs(v, attrs)
    if v.device.type == "cpu":
        return rasterize_winners_multi_ref(v, tri, top, n_levels, perspective,
                                           eps, attrs, tile, band)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    n_attr = 0 if attrs is None else attrs.shape[-1]
    rows, starts, slots, _ = launch_bin_multi(v, tri, top, n_levels, perspective, eps, tile,
                                              attrs, band)
    vals, wins = launch_rasterize_multi(rows, starts, slots, top, n_levels, tile, n_attr,
                                        perspective, eps, band)
    return split_levels(vals, wins, v.shape[0], top, n_levels, n_attr, nty * tile)


rasterize_winners_multi.launches = 0
rasterize_winners_multi.band_launches = 0


def bin_multi_host(v, tri, top: int, n_levels: int, perspective: bool, eps: float,
                   tile: int, attrs=None, band=None):
    """The card's binning compiled for the host (g++), on CPU tensors ->
    ``launch_bin_multi``'s (rows, starts, slots, keys); each segment in
    ascending id order."""
    from stylerenderer_tpu_torch.ops._build import library

    _check_inputs(v, attrs)
    ty0, nty = _check_band(top, n_levels, tile, band)
    v, tri, ab, K = _bin_args(v.cpu(), tri, top, n_levels, tile,
                              None if attrs is None else attrs.cpu())
    B, nv, _ = v.shape
    nf = tri.shape[0]
    n_attr = 0 if ab is None else ab.shape[-1]
    keys, starts, rows, slots = _bin_outputs(B, nf, K, n_attr, "cpu")
    rc = library("multi_host").sr_bin_multi_host(
        v.data_ptr(), tri.data_ptr(), _ptr(ab), keys.data_ptr(), starts.data_ptr(),
        rows.data_ptr(), slots.data_ptr(), B, nv, nf, top, n_levels, tile, n_attr,
        int(perspective), ty0, nty, ctypes.c_float(eps))
    if rc != 0:
        raise RuntimeError("host bin_multi rejected its arguments")
    return rows, starts, slots, keys


def rasterize_bins_multi_host(rows, starts, slots, top: int, n_levels: int, tile: int,
                              n_attr: int, perspective: bool = False, eps: float = 1e-6,
                              round_size: int = 0, queue: int = 0,
                              stats: dict | None = None, band=None):
    """The kernel's per-tile schedule and candidate math compiled for the
    host (g++) on binned rows (``bin_multi_host``) -> per level (values,
    winners) or winners, as ``rasterize_winners_multi``. ``round_size``
    candidates per round and a queue of ``queue`` coarse-level items (0:
    the kernel's own, ``csrc/rasterize_multi.cuh::kRound``, ``kQueue``);
    ``stats["flushes"]`` gets the number of times a full queue was worked
    through between rounds."""
    from stylerenderer_tpu_torch.ops._build import library

    _check_bins(rows, starts, slots, top, tile, n_attr, "cpu")
    ty0, nty = _check_band(top, n_levels, tile, band)
    B = rows.shape[0]
    vals, wins = _alloc_outputs(B, top, n_levels, n_attr, "cpu", nty * tile)
    rc = library("multi_host").sr_rasterize_multi_host(
        rows.data_ptr(), starts.data_ptr(), slots.data_ptr(), vals.data_ptr(), wins.data_ptr(), B,
        rows.shape[1], top, n_levels, tile, n_attr, int(perspective), ty0, nty,
        ctypes.c_float(eps), round_size, queue)
    if rc < 0:
        raise RuntimeError("host rasterize_multi rejected its arguments")
    if stats is not None:
        stats["flushes"] = rc
    return split_levels(vals, wins, B, top, n_levels, n_attr, nty * tile)


def rasterize_winners_multi_host(v, tri, top: int, n_levels: int,
                                 perspective: bool = False, eps: float = 1e-6,
                                 attrs=None, tile: int | None = None, band=None):
    """The card's binning and kernel compiled for the host (g++), on CPU
    tensors: the same output as ``rasterize_winners_multi`` on the card."""
    tile = _check_levels(top, n_levels, tile)
    _check_inputs(v, attrs)
    rows, starts, slots, _ = bin_multi_host(v, tri, top, n_levels, perspective, eps, tile,
                                            attrs, band)
    n_attr = 0 if attrs is None else attrs.shape[-1]
    return rasterize_bins_multi_host(rows, starts, slots, top, n_levels, tile, n_attr,
                                     perspective, eps, band=band)
