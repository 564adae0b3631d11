"""Multi-level pyramid rasterizer: binning, the Hopper kernel's wrapper and
its plain version (counterpart of the multi-level half of
``stylerenderer_tpu/ops/rasterize_pallas.py``).

One binning and one kernel pass produce the winner maps (and, with
``attrs``, the interpolated attribute maps) of every pyramid level ``top,
top/2, ..., top >> (n_levels-1)``, each bit-equal to the dense oracle
``ops/rasterize.py::rasterize_winners`` at that size.

- ``build_bins_multi``: plain torch on the tensor's device (sort,
  ``searchsorted``, gathers), as the JAX package leaves binning to XLA.
- ``rasterize_winners_multi``: the wrapper. A CUDA tensor goes to the kernel
  (``csrc/rasterize_multi.cu``, launched by ``launch_rasterize_multi``); a
  CPU tensor goes to the plain version.
- ``rasterize_winners_multi_ref``: the plain version, dense search per
  level then ``_interp_from_win``.
- ``rasterize_winners_multi_host``: the kernel's math built for the host
  (``csrc/rasterize_multi_host.cpp``), for the CPU tests.
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
                     eps: float, tile: int, attrs=None):
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
    - home is the top-left tile of the float bbox (floor, not ceil).

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


def split_levels(vals, wins, B: int, top: int, n_levels: int, n_attr: int):
    """Level-major flat outputs -> per level (values, winners) or winners."""
    outs = []
    off = 0
    for k in range(n_levels):
        s = top >> k
        n = B * s * s
        w = wins[off:off + n].view(B, s, s)
        if n_attr:
            outs.append((vals[off * n_attr:(off + n) * n_attr].view(B, s, s, n_attr), w))
        else:
            outs.append(w)
        off += n
    return outs


def _alloc_outputs(B, top, n_levels, n_attr, device):
    n = sum(B * (top >> k) ** 2 for k in range(n_levels))
    vals = torch.empty(max(n * n_attr, 1), dtype=torch.float32, device=device)
    wins = torch.empty(n, dtype=torch.int32, device=device)
    return vals, wins


def rasterize_winners_multi_ref(v, tri, top: int, n_levels: int,
                                perspective: bool = False, eps: float = 1e-6,
                                attrs=None, tile: int | None = None):
    """Plain version of the kernel: the dense search at every level, then
    ``_interp_from_win`` (the oracle of the bit-exact contract)."""
    _check_levels(top, n_levels, tile)
    v = v.detach().float()
    tri = torch.as_tensor(tri, device=v.device)
    tbl = None if attrs is None else _triangle_table(v, attrs.detach().float(), tri)
    outs = []
    for k in range(n_levels):
        s = top >> k
        win = rasterize_winners(v, tri, s, s, perspective, eps)
        if attrs is None:
            outs.append(win)
        else:
            with torch.no_grad():
                vals = _interp_from_win(v, attrs.detach().float(), tri, win, s, s,
                                        perspective, eps, tbl=tbl)
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


def _check_bins(dat, ids, starts, top: int, tile: int) -> int:
    """Validate ``build_bins_multi``'s output for the kernel -> n_attr."""
    B, nf, R = dat.shape
    n_attr, rem = divmod(R - 9, 3)
    ntiles = (top // tile) ** 2
    expect = ((dat, torch.float32, (B, nf, R)), (ids, torch.int32, (B, nf)),
              (starts, torch.int32, (B, MULTI_N_TIERS * ntiles + 1)))
    for t, dt, shape in expect:
        if t.device.type != "cuda" or t.device != dat.device:
            raise ValueError(f"kernel inputs must lie on one CUDA device, got {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"kernel input {t.dtype} {tuple(t.shape)} (contiguous: "
                             f"{t.is_contiguous()}), expected contiguous {dt} {shape}")
    if rem or not 0 <= n_attr <= 7:
        raise ValueError(f"dat rows {R}: expected 9 + 3C with C <= 7")
    return n_attr


def launch_rasterize_multi(dat, ids, starts, top: int, n_levels: int, tile: int,
                           perspective: bool, eps: float):
    """Launch the Hopper kernel on binned triangles (``build_bins_multi``)
    on the current stream -> flat level-major (values, winners). Counts the
    launch in ``rasterize_winners_multi.launches``; raises when the launch
    is refused."""
    from stylerenderer_tpu_torch.ops._build import library

    n_attr = _check_bins(dat, ids, starts, top, tile)
    lib = library("multi")
    B = dat.shape[0]
    vals, wins = _alloc_outputs(B, top, n_levels, n_attr, dat.device)
    stream = torch.cuda.current_stream(dat.device).cuda_stream
    rc = lib.sr_rasterize_multi(
        dat.data_ptr(), ids.data_ptr(), starts.data_ptr(), vals.data_ptr(),
        wins.data_ptr(), B, dat.shape[1], top, n_levels, tile, n_attr,
        int(perspective), eps, stream)
    if rc != 0:
        raise RuntimeError("rasterize_multi launch failed: "
                           + lib.sr_error_string(rc).decode())
    rasterize_winners_multi.launches += 1
    return vals, wins


def rasterize_winners_multi(v, tri, top: int, n_levels: int,
                            perspective: bool = False, eps: float = 1e-6,
                            attrs=None, tile: int | None = None):
    """Winner maps, or fused value maps, of the whole pyramid in one pass.

    ``attrs=None``: a list of ``n_levels`` winner maps ``[B, s, s]`` int32
    (-1 background), ``s = top >> k``. ``attrs`` ``[B, nv, C]`` (C <= 7): a
    list of ``(values [B, s, s, C] f32, winners [B, s, s] i32)``, values 0
    on background.

    A CUDA ``v`` launches the kernel (and counts the launch in
    ``rasterize_winners_multi.launches``); a CPU ``v`` takes the plain
    version. There is no fallback between the two.
    """
    tile = _check_levels(top, n_levels, tile)
    _check_inputs(v, attrs)
    if v.device.type == "cpu":
        return rasterize_winners_multi_ref(v, tri, top, n_levels, perspective,
                                           eps, attrs, tile)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    dat, ids, starts = build_bins_multi(v, tri, top, n_levels, perspective, eps,
                                        tile, attrs)
    vals, wins = launch_rasterize_multi(dat, ids, starts, top, n_levels, tile,
                                        perspective, eps)
    n_attr = 0 if attrs is None else attrs.shape[-1]
    return split_levels(vals, wins, v.shape[0], top, n_levels, n_attr)


rasterize_winners_multi.launches = 0


def rasterize_winners_multi_host(v, tri, top: int, n_levels: int,
                                 perspective: bool = False, eps: float = 1e-6,
                                 attrs=None, tile: int | None = None):
    """The kernel's candidate math and tile bookkeeping compiled for the host
    (g++), on CPU tensors: same binning, same output as the kernel."""
    from stylerenderer_tpu_torch.ops._build import library

    tile = _check_levels(top, n_levels, tile)
    _check_inputs(v, attrs)
    lib = library("multi_host")
    B = v.shape[0]
    n_attr = 0 if attrs is None else attrs.shape[-1]
    dat, ids, starts = build_bins_multi(v.cpu(), tri, top, n_levels, perspective,
                                        eps, tile, None if attrs is None else attrs.cpu())
    vals, wins = _alloc_outputs(B, top, n_levels, n_attr, "cpu")
    rc = lib.sr_rasterize_multi_host(
        dat.data_ptr(), ids.data_ptr(), starts.data_ptr(), vals.data_ptr(),
        wins.data_ptr(), B, dat.shape[1], top, n_levels, tile, n_attr,
        int(perspective), ctypes.c_float(eps))
    if rc != 0:
        raise RuntimeError("host rasterize_multi rejected its arguments")
    return split_levels(vals, wins, B, top, n_levels, n_attr)
