"""Windowed (binned) winner search for production meshes at high resolution
(counterpart of ``stylerenderer_tpu/ops/rasterize_binned.py``).

The JAX package's XLA scatter search, not a Pallas kernel, so plain
PyTorch here. The dense search (``ops/rasterize.py::rasterize_winners``)
evaluates every (triangle, pixel) pair, O(nf * H * W); face-mesh triangles
are a few pixels wide on screen, so this search evaluates each one only
inside a ``K x K`` window at its clamped bbox corner, for the smallest K of
``k_list`` that holds its span. The triangles wider than ``max(k_list)``
go, up to ``big_cap`` of the widest, to a dense pass over every pixel.

Two scatter phases over ``hw + 1`` slots per image (the last a sink for
the window pixels a triangle does not cover): phase A keeps each pixel's
max depth (``scatter_reduce_`` ``"amax"``), phase B the lowest triangle id
at that depth (``"amin"`` from ``2^31 - 1``). The candidate math is
``ops/rasterize.py``'s, so the winners are bit-equal to the dense search's
wherever ``big_overflow_count <= big_cap``: a pixel that a candidate with a
NaN depth covers is background, and so is one whose best depth is -inf.

Each K-bucket is compacted to its active triangles and evaluated in chunks,
so memory stays near one image's window pairs, and images run one at a
time. Runs on the tensor's device; the card's ``"auto"`` path takes the
single-level kernel instead (``ops/rasterize.py::_dispatch_winners``).
"""

from __future__ import annotations

import torch

from stylerenderer_tpu_torch.ops.rasterize import _eval_candidate, _project_verts

_NEG_INF = float("-inf")
_BIG_ID = 2**31 - 1


def _setup(vb, tri, h: int, w: int, perspective: bool, eps: float):
    """Per-triangle projected vertices, validity, clamped integer bbox corner
    and bbox span (0 where invalid) of one image ``vb [nv, 3]``."""
    nv = vb.shape[0]
    idx_ok = torch.all((tri >= 0) & (tri < nv), dim=-1)
    pts = vb[tri.clamp(0, nv - 1)]  # [nf, 3, 3]
    px, py, z, persp_ok = _project_verts(pts, h, w, perspective, eps)

    x0 = torch.clamp(torch.ceil(torch.amin(px, -1)), min=0.0)
    x1 = torch.clamp(torch.floor(torch.amax(px, -1)), max=w - 1.0)
    y0 = torch.clamp(torch.ceil(torch.amin(py, -1)), min=0.0)
    y1 = torch.clamp(torch.floor(torch.amax(py, -1)), max=h - 1.0)
    bbox_ok = (x1 >= x0) & (y1 >= y0)

    # backface cull, as _eval_candidate's ``front`` (the JAX expression)
    px0, px1, px2 = px[..., 0], px[..., 1], px[..., 2]
    py0, py1, py2 = py[..., 0], py[..., 1], py[..., 2]
    det = px1 * py2 - py1 * px2 + py0 * px2 - px0 * py2 + px0 * py1 - py0 * px1
    front = det <= eps

    valid = idx_ok & persp_ok & bbox_ok & front
    span = torch.where(valid, torch.maximum(x1 - x0, y1 - y0) + 1.0, torch.zeros_like(x0))
    # an invalid triangle's corner may be NaN; it is never read
    ax0 = torch.where(valid, x0, torch.zeros_like(x0)).long()
    ay0 = torch.where(valid, y0, torch.zeros_like(y0)).long()
    return px, py, z, persp_ok, ax0, ay0, span


def _chunk(n_pairs_per_tri: int, device) -> int:
    budget = (1 << 24) if device.type == "cuda" else (1 << 21)
    return max(1, budget // n_pairs_per_tri)


def _window_pass(ids, K, setup, h, w, perspective, eps, zbuf, poison):
    """Evaluate triangles ``ids`` in their K-windows and fold them into the
    z-buffer (phase A), marking the pixels a NaN depth covers in ``poison``.
    Returns the chunks ``(p, depth, ids)`` that phase B reads: ``p [n, K*K]``
    the pixel, or the sink ``hw`` where not covered; ``depth`` -inf there and
    at NaN depths."""
    px, py, z, persp_ok, ax0, ay0, _ = setup
    hw = h * w
    d = torch.arange(K, device=ids.device)
    out, n = [], _chunk(K * K, ids.device)
    for s in range(0, ids.numel(), n):
        t = ids[s:s + n]
        ax = ax0[t].clamp(0, max(w - K, 0))
        ay = ay0[t].clamp(0, max(h - K, 0))
        X = ax[:, None] + d[None, :]  # [n, K]
        Y = ay[:, None] + d[None, :]
        _, depth, cov = _eval_candidate(
            px[t][:, None, None, :], py[t][:, None, None, :], z[t][:, None, None, :],
            persp_ok[t][:, None, None], X.float()[:, None, :], Y.float()[:, :, None],
            h, w, perspective, eps)  # [n, K, K]
        p = torch.where(cov, Y[:, :, None] * w + X[:, None, :], hw).reshape(-1, K * K)
        cov, depth = cov.reshape(-1, K * K), depth.reshape(-1, K * K)
        nan = cov & torch.isnan(depth)
        poison[p[nan]] = True
        dm = torch.where(cov & ~nan, depth, _NEG_INF)
        zbuf.scatter_reduce_(0, p.reshape(-1), dm.reshape(-1), "amax")
        out.append((p, dm, t))
    return out


def _big_pass(ids, setup, h, w, perspective, eps):
    """Dense pass of triangles ``ids`` over every pixel: (max finite depth
    ``[hw]``, NaN-covered ``[hw]``, and the chunks ``(depth, ids)`` with
    -inf where not covered)."""
    px, py, z, persp_ok = setup[:4]
    hw = h * w
    pix = torch.arange(hw, device=ids.device)
    X = (pix % w).float()[None, :]
    Y = (pix // w).float()[None, :]
    zmax = torch.full((hw,), _NEG_INF, device=ids.device)
    poison = torch.zeros(hw, dtype=torch.bool, device=ids.device)
    out, n = [], _chunk(hw, ids.device)
    for s in range(0, ids.numel(), n):
        t = ids[s:s + n]
        _, depth, cov = _eval_candidate(
            px[t][:, None, :], py[t][:, None, :], z[t][:, None, :], persp_ok[t][:, None],
            X, Y, h, w, perspective, eps)  # [n, hw]
        nan = cov & torch.isnan(depth)
        poison |= nan.any(0)
        dm = torch.where(cov & ~nan, depth, _NEG_INF)
        zmax = torch.maximum(zmax, dm.amax(0))
        out.append((dm, t))
    return zmax, poison, out


def _per_image(vb, tri, h, w, perspective, eps, k_list, big_cap):
    hw = h * w
    kmax = max(k_list)
    setup = _setup(vb, tri, h, w, perspective, eps)
    span = setup[-1]
    dev = vb.device

    # the big triangles: the top big_cap by span among spans over kmax (ties
    # to the lowest id, as lax.top_k), dense over all pixels
    is_big = span > kmax
    n_big = is_big.sum().to(torch.int32)
    big = torch.nonzero(is_big).reshape(-1)
    big = big[torch.sort(span[big], descending=True, stable=True).indices[:big_cap]]
    big_zmax, big_poison, big_chunks = _big_pass(big, setup, h, w, perspective, eps)

    # phase A: the z-buffer (slot hw is the sink)
    zbuf = torch.full((hw + 1,), _NEG_INF, device=dev)
    zbuf[:hw] = big_zmax
    poison = torch.zeros(hw + 1, dtype=torch.bool, device=dev)
    poison[:hw] = big_poison
    passes, lo = [], 0.0
    for K in k_list:
        ids = torch.nonzero((span > 0) & (span <= K) & (span > lo)).reshape(-1)
        passes += _window_pass(ids, K, setup, h, w, perspective, eps, zbuf, poison)
        lo = float(K)

    # phase B: the lowest triangle id at the buffered depth
    win = torch.full((hw + 1,), _BIG_ID, dtype=torch.long, device=dev)
    for dm, t in big_chunks:
        hit = dm == zbuf[None, :hw]
        win[:hw] = torch.minimum(win[:hw], torch.where(hit, t[:, None], _BIG_ID).amin(0))
    for p, dm, t in passes:
        cand = torch.where(dm == zbuf[p], t[:, None], _BIG_ID)
        win.scatter_reduce_(0, p.reshape(-1), cand.reshape(-1), "amin")

    bg = (win == _BIG_ID) | poison | (zbuf == _NEG_INF)
    win = torch.where(bg, -1, win)[:hw].to(torch.int32)
    return win.reshape(h, w), n_big


@torch.no_grad()
def rasterize_winners_binned(v, tri, h: int, w: int, perspective: bool = False,
                             eps: float = 1e-6, k_list: tuple[int, ...] = (8, 32),
                             big_cap: int = 512, return_overflow: bool = False):
    """Winner map ``[B, H, W]`` (int32, -1 background) by the windowed scatter
    search. With ``return_overflow=True`` also the per-image count ``[B]``
    of triangles whose bbox span exceeds ``max(k_list)``: the winners are
    exact only while it stays ``<= big_cap``."""
    v = v.detach().float()
    tri = torch.as_tensor(tri, device=v.device).long()
    k_list = tuple(min(k, max(h, w)) for k in k_list)
    wins, n_big = zip(*(_per_image(vb, tri, h, w, perspective, eps, k_list, big_cap)
                        for vb in v))
    win = torch.stack(wins)
    if return_overflow:
        return win, torch.stack(n_big)
    return win


@torch.no_grad()
def big_overflow_count(v, tri, h: int, w: int, perspective: bool = False,
                       eps: float = 1e-6, k_list: tuple[int, ...] = (8, 32)):
    """Per-image count ``[B]`` (int32) of triangles larger than
    ``max(k_list)``: ``rasterize_winners_binned`` is exact while it stays
    ``<= big_cap``."""
    v = torch.as_tensor(v).detach().float()
    tri = torch.as_tensor(tri, device=v.device).long()
    kmax = min(max(k_list), max(h, w))
    return torch.stack([(_setup(vb, tri, h, w, perspective, eps)[-1] > kmax).sum()
                        .to(torch.int32) for vb in v])
