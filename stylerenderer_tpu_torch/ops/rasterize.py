"""Differentiable z-buffered triangle rasterization of per-vertex attributes
(counterpart of ``stylerenderer_tpu/ops/rasterize.py``).

Semantics, expressions and association order are the JAX package's, so
winner maps are bit-equal to it and to the Hopper kernels
(``ops/rasterize_multi.py``, ``ops/rasterize_single.py``):

- vertices are NDC; pixel transform ``px = (1+x)*W/2 - 0.5``,
  ``py = (1-y)*H/2 - 0.5``; optional perspective pre-divides x, y by ``-z``
  and culls any vertex with ``z >= -eps``;
- back faces (``det > eps``) are culled; the inside test is on the
  unnormalized coefficients (``>= -eps``) plus the clamped integer bbox;
- degenerate triangles fall back to the longest edge or to a point test;
- the z-test keeps the max z, ties go to the lowest triangle id;
- gradients are interpolation-only: the winner search runs on detached
  vertices and the winner's coefficients are recomputed differentiably.

Rounding rules kept on purpose (the CUDA oracle must round like the JAX
package and like the kernel):

- no division of a tensor by a Python scalar (CUDA computes it as a
  multiply by the reciprocal, which may lose a bit): scalars here only
  multiply, add or compare, and every reciprocal is ``1.0 / tensor``;
- no fused ops (``addcmul``, ``lerp``, ``baddbmm``): their rounding
  differs from the separate multiply and add the JAX package performs.

Layout: vertices ``[B, nv, 3]``, maps ``[B, H, W, C]`` (the JAX layout).
"""

from __future__ import annotations

import torch

from stylerenderer_tpu_torch.parallel.spatial import band_rows, enter_band

_NEG_INF = float("-inf")


def _project_verts(pts, h: int, w: int, perspective: bool, eps: float):
    """NDC -> pixel coords. pts [..., 3, 3] -> (px, py, z, persp_ok) each [..., 3]."""
    x = pts[..., 0]
    y = pts[..., 1]
    z = pts[..., 2]
    if perspective:
        ok = z < -eps
        zsafe = torch.where(ok, z, torch.full_like(z, -1.0))
        x = x / -zsafe
        y = y / -zsafe
        persp_ok = torch.all(ok, dim=-1)
    else:
        persp_ok = torch.ones(pts.shape[:-2], dtype=torch.bool, device=pts.device)
    px = (1.0 + x) * (w / 2.0) - 0.5
    py = (1.0 - y) * (h / 2.0) - 0.5
    return px, py, z, persp_ok


def _sel3(t0, t1, t2, idx):
    return torch.where(idx == 0, t0, torch.where(idx == 1, t1, t2))


def _eval_candidate(px, py, z, persp_ok, X, Y, h: int, w: int,
                    perspective: bool, eps: float):
    """Evaluate one triangle at pixel coords (X, Y).

    px/py/z: [..., 3] projected vertices; X/Y broadcastable to the result.
    Returns (coeff [..., 3], depth [...], covered [...]). Every branch uses
    safe denominators so the expression is differentiable everywhere.
    """
    px0, px1, px2 = px[..., 0], px[..., 1], px[..., 2]
    py0, py1, py2 = py[..., 0], py[..., 1], py[..., 2]

    a0 = px1 * py2 - py1 * px2
    a1 = py0 * px2 - px0 * py2
    a2 = px0 * py1 - py0 * px1
    det = a0 + a1 + a2
    front = det <= eps
    sign = torch.where(det < 0, -1.0, 1.0).to(det.dtype)
    det_pos = det * sign

    b0 = (py1 - py2) * sign
    b1 = (py2 - py0) * sign
    b2 = (py0 - py1) * sign
    c0 = (px2 - px1) * sign
    c1 = (px0 - px2) * sign
    c2 = (px1 - px0) * sign
    a0, a1, a2 = a0 * sign, a1 * sign, a2 * sign

    umin = torch.minimum(torch.minimum(px0, px1), px2)
    umax = torch.maximum(torch.maximum(px0, px1), px2)
    vmin = torch.minimum(torch.minimum(py0, py1), py2)
    vmax = torch.maximum(torch.maximum(py0, py1), py2)
    x0 = torch.clamp(torch.ceil(umin), min=0.0)
    x1 = torch.clamp(torch.floor(umax), max=w - 1.0)
    y0 = torch.clamp(torch.ceil(vmin), min=0.0)
    y1 = torch.clamp(torch.floor(vmax), max=h - 1.0)
    bbox_ok = (x1 >= x0) & (y1 >= y0)
    in_bbox = (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)

    r0 = a0 + b0 * X + c0 * Y
    r1 = a1 + b1 * X + c1 * Y
    r2 = a2 + b2 * X + c2 * Y
    raw_ok = (r0 >= -eps) & (r1 >= -eps) & (r2 >= -eps)

    nondeg = det_pos > eps

    s = r0 + r1 + r2
    s_safe = torch.where(torch.abs(s) > 1e-30, s, torch.ones_like(s))
    # one reciprocal and three multiplies, as every backend does
    s_inv = 1.0 / s_safe
    cn0 = torch.clamp(r0 * s_inv, -1.0, 2.0)
    cn1 = torch.clamp(r1 * s_inv, -1.0, 2.0)
    cn2 = torch.clamp(r2 * s_inv, -1.0, 2.0)

    # degenerate fallback: project onto the longest edge, or a point test
    l0 = b0 * b0 + c0 * c0
    l1 = b1 * b1 + c1 * c1
    l2 = b2 * b2 + c2 * c2
    i_idx = torch.where(l0 > l1, 0, 1)
    li_val = torch.where(i_idx == 0, l0, l1)
    i_idx = torch.where(li_val > l2, i_idx, 2)
    j_idx = (i_idx + 1) % 3
    k_idx = (j_idx + 1) % 3
    b_i = _sel3(b0, b1, b2, i_idx)
    c_i = _sel3(c0, c1, c2, i_idx)
    l_i = _sel3(l0, l1, l2, i_idx)
    px_i = _sel3(px0, px1, px2, i_idx)
    py_i = _sel3(py0, py1, py2, i_idx)
    px_j = _sel3(px0, px1, px2, j_idx)
    py_j = _sel3(py0, py1, py2, j_idx)
    px_k = _sel3(px0, px1, px2, k_idx)
    py_k = _sel3(py0, py1, py2, k_idx)

    seg = l_i > eps
    lj = -(X - px_k) * c_i + (Y - py_k) * b_i
    lk = (X - px_j) * c_i - (Y - py_j) * b_i
    lsum = lj + lk
    lsum_safe = torch.where(torch.abs(lsum) > 1e-30, lsum, torch.ones_like(lsum))
    cj = torch.clamp(lj / lsum_safe, -1.0, 2.0)
    ck = torch.clamp(lk / lsum_safe, -1.0, 2.0)
    seg_ok = (cj >= -eps) & (ck >= -eps)

    dx = X - px_i
    dy = Y - py_i
    pt_ok = dx * dx + dy * dy < eps

    zero = torch.zeros_like(cj)
    one = torch.ones_like(cj)

    def deg_coeff(target):
        seg_c = torch.where(target == i_idx, zero,
                            torch.where(target == j_idx, cj, ck))
        pt_c = torch.where(target == i_idx, one, zero)
        return torch.where(seg, seg_c, pt_c)

    deg_ok = torch.where(seg, seg_ok, pt_ok)
    co0 = torch.where(nondeg, cn0, deg_coeff(0))
    co1 = torch.where(nondeg, cn1, deg_coeff(1))
    co2 = torch.where(nondeg, cn2, deg_coeff(2))
    cov = (front & persp_ok & bbox_ok & in_bbox & raw_ok
           & (nondeg | deg_ok))

    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    if perspective:
        m1 = torch.full_like(z0, -1.0)
        z0s = torch.where(z0 < -eps, z0, m1)
        z1s = torch.where(z1 < -eps, z1, m1)
        z2s = torch.where(z2 < -eps, z2, m1)
        # reciprocal of the per-triangle z, then a multiply (not co / z)
        q0 = co0 * (1.0 / z0s)
        q1 = co1 * (1.0 / z1s)
        q2 = co2 * (1.0 / z2s)
        depth = q0 + q1 + q2
        cov = cov & (depth < -eps)
        co0 = q0 * depth
        co1 = q1 * depth
        co2 = q2 * depth
    else:
        depth = co0 * z0 + co1 * z1 + co2 * z2
    return torch.stack([co0, co1, co2], dim=-1), depth, cov


def _auto_chunk(nf: int, bhw: int, budget: int) -> int:
    """Triangles per dense step, keeping ``[B, T, HW]`` near ``budget``
    elements (``bhw = B * H * W``)."""
    return int(min(max(1, budget // max(bhw, 1)), max(nf, 1)))


@torch.no_grad()
def rasterize_winners(v, tri, h: int, w: int, perspective: bool = False,
                      eps: float = 1e-6, chunk: int | None = None, rows=None):
    """Dense winner search: ``[B, H, W]`` int32 triangle index, -1 background;
    with ``rows = (y0, y1)``, only those rows of the ``h x w`` image,
    ``[B, y1 - y0, W]``, each pixel as in the whole image.

    Every (triangle, pixel) pair is evaluated, triangles in chunks; the test
    oracle and the plain version of both kernels. A pixel that a triangle
    with a NaN depth covers is background whatever the other triangles are,
    as in the JAX package's Pallas kernels, whose running max turns NaN
    there; the answer does not depend on ``chunk``. (The JAX dense oracle
    only skips the NaN's chunk, so there a triangle of another chunk can
    still win.)
    """
    v = v.detach().float()
    tri = torch.as_tensor(tri, device=v.device).long()
    B, nv, _ = v.shape
    nf = tri.shape[0]
    y0, y1 = (0, h) if rows is None else rows
    hw = (y1 - y0) * w
    if chunk is None:
        chunk = _auto_chunk(nf, B * hw, (1 << 24) if v.is_cuda else (1 << 22))
    ys = torch.arange(y0 * w, y1 * w, device=v.device) // w
    xs = torch.arange(hw, device=v.device) % w
    X = xs.float()[None, None, :]
    Y = ys.float()[None, None, :]
    zbest = torch.full((B, hw), _NEG_INF, device=v.device)
    tbest = torch.full((B, hw), -1, dtype=torch.int32, device=v.device)
    poisoned = torch.zeros((B, hw), dtype=torch.bool, device=v.device)
    for start in range(0, nf, chunk):
        tc = tri[start:start + chunk]
        T = tc.shape[0]
        idx_ok = torch.all((tc >= 0) & (tc < nv), dim=-1)
        tc_safe = tc.clamp(0, nv - 1)
        pts = v[:, tc_safe.reshape(-1), :].reshape(B, T, 3, 3)
        px, py, z, persp_ok = _project_verts(pts, h, w, perspective, eps)
        _, depth, cov = _eval_candidate(
            px[:, :, None, :], py[:, :, None, :], z[:, :, None, :],
            persp_ok[:, :, None], X, Y, h, w, perspective, eps)
        cov = cov & idx_ok[None, :, None]
        poisoned |= torch.any(cov & torch.isnan(depth), dim=1)
        zm = torch.where(cov, depth, torch.full_like(depth, _NEG_INF))
        z_c = torch.amax(zm, dim=1)
        # lowest triangle id among the chunk's maxima
        tid = torch.arange(T, device=v.device)[None, :, None]
        i_c = torch.where(cov & (zm == z_c[:, None, :]), tid, T).amin(dim=1)
        upd = z_c > zbest
        zbest = torch.where(upd, z_c, zbest)
        tbest = torch.where(upd, (i_c + start).to(torch.int32), tbest)
    tbest = torch.where(poisoned, -1, tbest)
    return tbest.reshape(B, y1 - y0, w)


def _triangle_table(v, tex_b, tri):
    """Per-triangle corner table ``[B, nf, 3, 3+C]`` (corner xyz + corner
    attributes), built once and shared across pyramid levels. Out-of-range
    vertex ids are clipped: those triangles never win, so their rows are
    only read behind a zero coefficient."""
    if tex_b is None:
        src = v
    else:
        dt = torch.promote_types(v.dtype, tex_b.dtype)
        src = torch.cat([v.to(dt), tex_b.to(dt)], dim=-1)
    nf = tri.shape[0]
    vids = tri.long().reshape(-1).clamp(0, src.shape[1] - 1)
    return src[:, vids, :].reshape(src.shape[0], nf, 3, src.shape[-1])


def _winner_gather(v, tex_b, tri, win, h: int, w: int, tbl=None):
    """Per-pixel gather of the winning triangle's row of the triangle table
    (``win`` ``[B, h, w]``: an image, or a band of ``h`` rows of one).

    Returns (vidx [B,H,W,3], pts [B,H,W,3,3], gtex [B,H,W,3,C] or None).
    """
    B = v.shape[0]
    nf = tri.shape[0]
    win_safe = win.long().clamp(0, nf - 1)
    vidx = tri.long()[win_safe]
    if tbl is None:
        tbl = _triangle_table(v, tex_b, tri)
    R = tbl.shape[-1]
    rows = torch.gather(
        tbl.reshape(B, nf, 3 * R), 1,
        win_safe.reshape(B, h * w, 1).expand(B, h * w, 3 * R),
    ).reshape(B, h, w, 3, R)
    pts = rows[..., :3].to(v.dtype)
    gtex = rows[..., 3:] if tex_b is not None else None
    return vidx, pts, gtex


def _coeff_from_pts(pts, h: int, w: int, perspective: bool, eps: float, y0: int = 0):
    """Differentiable barycentric coefficients at every pixel center for the
    per-pixel triangle vertices ``pts [B, hb, W, 3, 3]`` of rows
    ``[y0, y0 + hb)`` of an ``h x w`` image."""
    hb = pts.shape[1]
    idx = torch.arange(hb * w, device=pts.device)
    X = (idx % w).float().reshape(1, hb, w)
    Y = (idx // w + y0).float().reshape(1, hb, w)
    px, py, z, persp_ok = _project_verts(pts, h, w, perspective, eps)
    coeff, _, _ = _eval_candidate(px, py, z, persp_ok, X, Y, h, w,
                                  perspective, eps)
    return coeff


def winner_coeff(v, tri, win, h: int, w: int, perspective: bool = False,
                 eps: float = 1e-6):
    """Differentiable coefficients of the winning triangles: (coeff
    ``[B,H,W,3]``, vidx ``[B,H,W,3]``), both zero on background."""
    valid = (win >= 0)[..., None]
    vidx, pts, _ = _winner_gather(v, None, tri, win, h, w)
    coeff = _coeff_from_pts(pts, h, w, perspective, eps)
    coeff = torch.where(valid, coeff, torch.zeros_like(coeff))
    vidx = torch.where(valid, vidx, torch.zeros_like(vidx))
    return coeff, vidx


def _dispatch_winners(v, tri, h, w, perspective, eps, method):
    """The winner search for ``method``, by the JAX package's names
    (``rasterize.py:399``):

    - ``"auto"``: the dense search when ``nf*h*w <= 2^24`` or h or w is not
      a multiple of 8; above that, the single-level kernel on a CUDA
      tensor and the binned search on a CPU tensor (as JAX takes its
      kernel on the TPU and the binned search off it). The card's path
      never reaches the binned search unless it is named;
    - ``"dense"``: the dense search;
    - ``"pallas"``: the single-level kernel (``rasterize_single.py``);
    - ``"binned"``: the windowed scatter search (``rasterize_binned.py``,
      plain PyTorch), on either device.

    ``"pallas_multi"`` names the multi-level pass of the pyramid functions,
    which send the sizes it does not cover here as ``"auto"``; here it is
    refused, as in JAX. A kernel's wrapper runs its plain version on a CPU
    tensor."""
    if method == "auto":
        nf = tri.shape[0]
        if nf * h * w <= (1 << 24) or h % 8 or w % 8:
            method = "dense"
        else:
            method = "pallas" if v.is_cuda else "binned"
    if method == "dense":
        return rasterize_winners(v, tri, h, w, perspective, eps)
    if method == "pallas":
        from stylerenderer_tpu_torch.ops.rasterize_single import rasterize_winners_single

        return rasterize_winners_single(v, tri, h, w, perspective, eps)
    if method == "binned":
        from stylerenderer_tpu_torch.ops.rasterize_binned import rasterize_winners_binned

        return rasterize_winners_binned(v, tri, h, w, perspective, eps)
    raise ValueError(f"unknown rasterize method {method!r}")


def rasterize_index_coeff(v, tri, h: int = 256, w: int = 0,
                          perspective: bool = False, eps: float = 1e-6,
                          method: str = "auto"):
    """Per-pixel vertex-index triplet and interpolation coefficients
    (0 / 0 on background)."""
    if v.ndim == 2:
        v = v[None]
    w = w if w > 0 else h
    win = _dispatch_winners(v, tri, h, w, perspective, eps, method)
    coeff, vidx = winner_coeff(v, tri, win, h, w, perspective, eps)
    return vidx, coeff


def _interp_from_win(v, tex_b, tri, win, h, w, perspective, eps, tbl=None, y0: int = 0):
    """Differentiable interpolation given a winner map: one per-pixel row
    gather, the coefficient recompute (the gradient path), weighted sum.
    ``win`` is the ``h x w`` image's map, or the map of its rows
    ``[y0, y0 + win.shape[1])``."""
    valid = (win >= 0)[..., None]
    _, pts, gathered = _winner_gather(v, tex_b, tri, win, win.shape[1], w, tbl=tbl)
    coeff = _coeff_from_pts(pts, h, w, perspective, eps, y0)
    coeff = torch.where(valid, coeff, torch.zeros_like(coeff))
    cf = coeff[..., None].to(gathered.dtype)
    # explicit (c0*a0 + c1*a1) + c2*a2: the kernel interpolates in this
    # order, so fused values stay bit-equal to this oracle
    out = (cf[..., 0, :] * gathered[..., 0, :]
           + cf[..., 1, :] * gathered[..., 1, :]
           + cf[..., 2, :] * gathered[..., 2, :])
    return out.to(tex_b.dtype)


def rasterize(v, tex, tri, h: int = 256, w: int = 0, perspective: bool = False,
              eps: float = 1e-6, method: str = "auto"):
    """Rasterize per-vertex attributes ``tex`` over the mesh ``(v, tri)``.

    ``v`` ``[B, nv, 3]`` (or ``[nv, 3]``), ``tex`` ``[B, nv, C]`` or
    ``[B, nv]`` -> ``[B, H, W, C]`` (or ``[B, H, W]``); differentiable in
    ``v`` (interpolation only) and ``tex``.
    """
    scalar_tex = tex.ndim == v.ndim - 1
    squeeze_batch = v.ndim == 2
    if squeeze_batch:
        v, tex = v[None], tex[None]
    tex_b = tex[..., None] if scalar_tex else tex
    w = w if w > 0 else h
    win = _dispatch_winners(v, tri, h, w, perspective, eps, method)
    out = _interp_from_win(v, tex_b, tri, win, h, w, perspective, eps)
    if scalar_tex:
        out = out[..., 0]
    if squeeze_batch:
        out = out[0]
    return out


# --------------------------------------------------------------------------
# the normal-map pyramid through the multi-level kernel
# --------------------------------------------------------------------------


def default_tile(top: int) -> int:
    """The multi-level kernel's tile for a ``top``-px pyramid."""
    return 16 if top <= 256 else 32


def _multi_levels(sizes, method: str, n_attr: int | None):
    """The JAX package's rule for the fused pyramid: the levels the
    multi-level pass covers (the power-of-two tail ``top, top/2, ...`` of
    ``sizes``), or ``[]`` when it does not apply (more than 7 channels, a
    ``top`` that is no multiple of the tile, or a method other than
    ``"auto"`` and ``"pallas_multi"``)."""
    if method not in ("auto", "pallas_multi"):
        return []
    if n_attr is not None and n_attr > 7:
        return []
    top = max(sizes)
    if top % default_tile(top):
        return []
    covered = []
    k = 0
    while (top >> k) >= 1 and (top >> k) in sizes:
        covered.append(top >> k)
        k += 1
    return covered


class _FusedLevels(torch.autograd.Function):
    """Forward: the multi-level kernel interpolates the winners' attributes
    in-kernel and returns the winner maps (of the band of tile rows
    ``band``, with its ``tile``, or of the whole image). Backward: plain
    autograd through ``_interp_from_win`` per level with ONE shared
    triangle table, seeded with the saved winner maps — the
    interpolation-only gradients of ``rasterize_pyramid`` (first order
    only)."""

    @staticmethod
    def forward(ctx, v, tex_b, tri, top, covered, perspective, eps, tile, band):
        from stylerenderer_tpu_torch.ops.rasterize_multi import (
            band_level_rows,
            rasterize_winners_multi,
        )
        outs = rasterize_winners_multi(v.detach(), tri, top, len(covered),
                                       perspective, eps,
                                       attrs=tex_b.detach().float(), tile=tile, band=band)
        wins = [w for _, w in outs]
        ctx.save_for_backward(v, tex_b, tri, *wins)
        ctx.covered, ctx.perspective, ctx.eps = covered, perspective, eps
        ctx.y0 = [0 if band is None else band_level_rows(top, tile, band, k)[0]
                  for k in range(len(covered))]
        return tuple(va.to(tex_b.dtype) for va, _ in outs)

    @staticmethod
    def backward(ctx, *cts):
        v, tex_b, tri, *wins = ctx.saved_tensors
        with torch.enable_grad():
            vv = v.detach().requires_grad_(True)
            tt = tex_b.detach().requires_grad_(True)
            tbl = _triangle_table(vv, tt, tri)
            outs = [_interp_from_win(vv, tt, tri, win, s, s, ctx.perspective,
                                     ctx.eps, tbl=tbl, y0=y0)
                    for win, s, y0 in zip(wins, ctx.covered, ctx.y0)]
            gv, gt = torch.autograd.grad(outs, (vv, tt), grad_outputs=cts,
                                         allow_unused=True)
        return gv, gt, None, None, None, None, None, None, None


def rasterize_pyramid_fused(v, tex, tri, sizes, perspective: bool = False,
                            eps: float = 1e-6, method: str = "auto", mesh=None):
    """``rasterize_pyramid`` with the attribute interpolation inside the
    multi-level kernel: one binning and one kernel pass produce the finished
    value maps of the power-of-two tail of ``sizes``; other sizes take the
    dense search. Values and winners are bit-equal to the dense oracle;
    gradients (first order) are ``rasterize_pyramid``'s.

    With a ``mesh`` (``parallel/mesh.py``) that splits rows over
    ``'space'``, ``v`` and ``tex`` are replicated and each map is this
    rank's band of rows (``parallel/spatial.py::band_rows``): the kernel
    renders only the band's tiles of every level it covers
    (``rasterize_multi.py::space_band``); the other sizes are searched
    whole and cut. The gradients in ``v`` and ``tex`` are then the band's
    share, and are summed over ``'space'`` on the way out, so each rank
    holds the whole gradient of a replicated input."""
    if v.ndim == 2:
        v, tex = v[None], tex[None]
    scalar_tex = tex.ndim == v.ndim - 1
    tex_b = tex[..., None] if scalar_tex else tex
    sizes = list(sizes)
    tri = torch.as_tensor(tri, device=v.device)
    n_space = 1 if mesh is None else mesh.n_space
    if n_space > 1:
        v, tex_b = enter_band(v, mesh), enter_band(tex_b, mesh)
    maps = {}
    covered = _multi_levels(sizes, method, tex_b.shape[-1])
    if covered:
        tile = band = None
        if n_space > 1:
            from stylerenderer_tpu_torch.ops.rasterize_multi import space_band

            tile, band = space_band(covered[0], len(covered), n_space, mesh.space_index)
        fused = _FusedLevels.apply(v, tex_b, tri, covered[0], covered,
                                   perspective, eps, tile, band)
        maps = dict(zip(covered, fused))
    meth = "auto" if method == "pallas_multi" else method
    results = []
    for s in sizes:
        m = maps.get(s)
        if m is None:
            win = _dispatch_winners(v, tri, s, s, perspective, eps, meth)
            y0 = 0
            if n_space > 1:
                rows = band_rows(mesh, s)
                win, y0 = win[:, rows], rows.start
            m = _interp_from_win(v, tex_b, tri, win, s, s, perspective, eps, y0=y0)
        m = m.to(tex_b.dtype)
        results.append(m[..., 0] if scalar_tex else m)
    return results


def rasterize_pyramid(v, tex, tri, sizes, perspective: bool = False,
                      eps: float = 1e-6, method: str = "auto"):
    """``tex`` rasterized at every size in ``sizes``, ``[B, s, s, C]`` each,
    bit-equal to per-size ``rasterize``. The power-of-two tail of ``sizes``
    takes its winners from ONE multi-level kernel pass (winners-only mode);
    gradients flow through the per-level coefficient recompute."""
    if v.ndim == 2:
        v, tex = v[None], tex[None]
    tex_b = tex[..., None] if tex.ndim == v.ndim - 1 else tex
    sizes = list(sizes)
    tri = torch.as_tensor(tri, device=v.device)
    wins = {}
    covered = _multi_levels(sizes, method, None)
    if len(covered) > 1:
        from stylerenderer_tpu_torch.ops.rasterize_multi import (
            rasterize_winners_multi,
        )
        outs = rasterize_winners_multi(v.detach(), tri, covered[0],
                                       len(covered), perspective, eps)
        wins = dict(zip(covered, outs))
    meth = "auto" if method == "pallas_multi" else method
    tbl = _triangle_table(v, tex_b, tri)
    results = []
    for s in sizes:
        win = wins.get(s)
        if win is None:
            win = _dispatch_winners(v, tri, s, s, perspective, eps, meth)
        results.append(_interp_from_win(v, tex_b, tri, win, s, s, perspective,
                                        eps, tbl=tbl))
    return results
