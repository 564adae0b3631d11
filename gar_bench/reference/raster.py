"""Plain z-buffered rasterization of per-vertex attributes: the normal
pyramid of the GAR, written for the benchmark's check.

Semantics (those the GAR's renderer states): vertices in NDC, orthographic;
pixel centres at ``px = (1 + x) * s / 2 - 0.5``, ``py = (1 - y) * s / 2 -
0.5``; back faces (``det > eps``) are culled; a pixel is covered when its
integer coordinates lie in the triangle's clamped bbox and the three
unnormalised edge functions are ``>= -eps`` (degenerate triangles fall back
to their longest edge or to a point test); the largest depth wins, ties go
to the lowest triangle id; a pixel covered by a NaN depth is background.
The value at a pixel is the winner's corner attributes weighted by its
clamped barycentric coefficients, ``(c0 a0 + c1 a1) + c2 a2``, zero on
background. Gradients flow through the coefficients of the fixed winners
(interpolation only).

The search enumerates, for each front-facing triangle, the pixels of its
clamped bbox (in chunks of pairs) and keeps the best pair per pixel with one
``scatter_reduce`` over 64-bit keys ``(ordered depth, inverted id)``. It is
independent of any kernel: it computes every level from the vertices.
"""

from __future__ import annotations

import torch

_PAIR_CHUNK = 1 << 24
_LOW = 0xFFFFFFFF


def project(pts, s: int):
    """NDC corners ``[..., 3, 3]`` -> pixel coordinates ``px, py`` and ``z``,
    each ``[..., 3]``, at an ``s x s`` level."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return (1.0 + x) * (s / 2.0) - 0.5, (1.0 - y) * (s / 2.0) - 0.5, z


def _sel3(t0, t1, t2, idx):
    return torch.where(idx == 0, t0, torch.where(idx == 1, t1, t2))


def candidate(px, py, z, X, Y, s: int, eps: float):
    """One triangle (corners ``px, py, z`` ``[..., 3]``) at pixel ``(X, Y)``
    -> (coefficients ``[..., 3]``, depth, covered)."""
    px0, px1, px2 = px.unbind(-1)
    py0, py1, py2 = py.unbind(-1)
    a0 = px1 * py2 - py1 * px2
    a1 = py0 * px2 - px0 * py2
    a2 = px0 * py1 - py0 * px1
    det = a0 + a1 + a2
    front = det <= eps
    sign = torch.where(det < 0, -1.0, 1.0).to(det.dtype)
    det_pos = det * sign
    b0, b1, b2 = (py1 - py2) * sign, (py2 - py0) * sign, (py0 - py1) * sign
    c0, c1, c2 = (px2 - px1) * sign, (px0 - px2) * sign, (px1 - px0) * sign
    a0, a1, a2 = a0 * sign, a1 * sign, a2 * sign

    x0 = torch.clamp(torch.ceil(torch.minimum(torch.minimum(px0, px1), px2)), min=0.0)
    x1 = torch.clamp(torch.floor(torch.maximum(torch.maximum(px0, px1), px2)), max=s - 1.0)
    y0 = torch.clamp(torch.ceil(torch.minimum(torch.minimum(py0, py1), py2)), min=0.0)
    y1 = torch.clamp(torch.floor(torch.maximum(torch.maximum(py0, py1), py2)), max=s - 1.0)
    in_bbox = (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)

    r0 = a0 + b0 * X + c0 * Y
    r1 = a1 + b1 * X + c1 * Y
    r2 = a2 + b2 * X + c2 * Y
    raw_ok = (r0 >= -eps) & (r1 >= -eps) & (r2 >= -eps)
    nondeg = det_pos > eps
    rsum = r0 + r1 + r2
    inv = 1.0 / torch.where(torch.abs(rsum) > 1e-30, rsum, torch.ones_like(rsum))
    cn = [torch.clamp(r * inv, -1.0, 2.0) for r in (r0, r1, r2)]

    # degenerate: the longest edge (i: the edge opposite corner i), or a point
    l0, l1, l2 = b0 * b0 + c0 * c0, b1 * b1 + c1 * c1, b2 * b2 + c2 * c2
    i = torch.where(l0 > l1, 0, 1)
    i = torch.where(torch.where(i == 0, l0, l1) > l2, i, 2)
    j, k = (i + 1) % 3, (i + 2) % 3
    b_i, c_i, l_i = _sel3(b0, b1, b2, i), _sel3(c0, c1, c2, i), _sel3(l0, l1, l2, i)
    pxj, pyj = _sel3(px0, px1, px2, j), _sel3(py0, py1, py2, j)
    pxk, pyk = _sel3(px0, px1, px2, k), _sel3(py0, py1, py2, k)
    seg = l_i > eps
    lj = -(X - pxk) * c_i + (Y - pyk) * b_i
    lk = (X - pxj) * c_i - (Y - pyj) * b_i
    lsum = lj + lk
    lsum = torch.where(torch.abs(lsum) > 1e-30, lsum, torch.ones_like(lsum))
    cj = torch.clamp(lj / lsum, -1.0, 2.0)
    ck = torch.clamp(lk / lsum, -1.0, 2.0)
    dx, dy = X - _sel3(px0, px1, px2, i), Y - _sel3(py0, py1, py2, i)
    deg_ok = torch.where(seg, (cj >= -eps) & (ck >= -eps), dx * dx + dy * dy < eps)
    zero, one = torch.zeros_like(cj), torch.ones_like(cj)
    co = []
    for t in range(3):
        seg_c = torch.where(i == t, zero, torch.where(j == t, cj, ck))
        deg_c = torch.where(seg, seg_c, torch.where(i == t, one, zero))
        co.append(torch.where(nondeg, cn[t], deg_c))
    cov = front & (x1 >= x0) & (y1 >= y0) & in_bbox & raw_ok & (nondeg | deg_ok)
    z0, z1, z2 = z.unbind(-1)
    depth = co[0] * z0 + co[1] * z1 + co[2] * z2
    return torch.stack(co, -1), depth, cov


def bbox_candidates(v, tri, s: int, eps: float):
    """Per (image, triangle): clamped integer bbox ``x0, y0, nx, ny`` and
    whether it is a candidate at all (ids in range, front-facing, a bbox
    that holds a pixel centre). ``v`` ``[B, nv, 3]`` -> tensors ``[B, nf]``."""
    nv = v.shape[1]
    ok = torch.all((tri >= 0) & (tri < nv), dim=-1)
    pts = v[:, tri.clamp(0, nv - 1).reshape(-1)].reshape(v.shape[0], tri.shape[0], 3, 3)
    px, py, _ = project(pts, s)
    x0 = torch.clamp(torch.ceil(px.amin(-1)), min=0.0)
    x1 = torch.clamp(torch.floor(px.amax(-1)), max=s - 1.0)
    y0 = torch.clamp(torch.ceil(py.amin(-1)), min=0.0)
    y1 = torch.clamp(torch.floor(py.amax(-1)), max=s - 1.0)
    px0, px1, px2 = px.unbind(-1)
    py0, py1, py2 = py.unbind(-1)
    det = (px1 * py2 - py1 * px2) + (py0 * px2 - px0 * py2) + (px0 * py1 - py0 * px1)
    cand = ok[None] & (det <= eps) & (x1 >= x0) & (y1 >= y0)
    nx = torch.where(cand, x1 - x0 + 1, 0).long()
    ny = torch.where(cand, y1 - y0 + 1, 0).long()
    return x0.long(), y0.long(), nx, ny, cand


def _ordered(depth):
    """f32 -> int64 whose order is the floats' order."""
    i = depth.contiguous().view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF).long()


@torch.no_grad()
def winners(v, tri, s: int, eps: float = 1e-6):
    """Winner ids ``[B, s, s]`` (int64, -1 background) of the mesh ``(v,
    tri)`` at an ``s x s`` level."""
    v = v.detach().float()
    tri = tri.long()
    B, nf = v.shape[0], tri.shape[0]
    x0, y0, nx, ny, _ = bbox_candidates(v, tri, s, eps)
    n = (nx * ny).reshape(-1)
    flat = torch.nonzero(n).squeeze(1)
    counts = n[flat]
    best = torch.full((B * s * s,), torch.iinfo(torch.int64).min, dtype=torch.int64,
                      device=v.device)
    poison = torch.zeros(B * s * s, dtype=torch.bool, device=v.device)
    ends = torch.cumsum(counts, 0)
    start, total = 0, int(ends[-1]) if ends.numel() else 0
    lo = 0
    while start < total:
        # a chunk of whole triangles holding about _PAIR_CHUNK pairs
        hi = int(torch.searchsorted(ends, start + _PAIR_CHUNK, right=True))
        hi = max(hi, lo + 1)
        ids, cnt = flat[lo:hi], counts[lo:hi]
        P = int(cnt.sum())
        rep = torch.repeat_interleave(torch.arange(ids.numel(), device=v.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(P, device=v.device) - first[rep]
        g = ids[rep]
        b, t = g // nf, g % nf
        wx = nx.reshape(-1)[g]
        X = (x0.reshape(-1)[g] + off % wx).float()
        Y = (y0.reshape(-1)[g] + off // wx).float()
        pts = v[b[:, None], tri[t]]  # [P, 3, 3]
        px, py, z = project(pts, s)
        _, depth, cov = candidate(px, py, z, X, Y, s, eps)
        pix = b * (s * s) + Y.long() * s + X.long()
        poison.index_fill_(0, pix[cov & torch.isnan(depth)], True)
        keep = cov & ~torch.isnan(depth)
        key = (_ordered(depth[keep]) * (1 << 32)) | (_LOW - t[keep])
        best.scatter_reduce_(0, pix[keep], key, "amax", include_self=True)
        start, lo = int(ends[hi - 1]), hi
    win = torch.where(best == torch.iinfo(torch.int64).min, -1, _LOW - (best & _LOW))
    win = torch.where(poison, -1, win)
    return win.reshape(B, s, s)


def interpolate(v, attrs, tri, win, s: int, eps: float = 1e-6):
    """Values ``[B, s, s, C]`` of the winners ``win`` (differentiable in
    ``v`` and ``attrs`` through the recomputed coefficients)."""
    B = v.shape[0]
    valid = win >= 0
    t = win.clamp(min=0)
    corners = tri.long()[t]  # [B, s, s, 3]
    bi = torch.arange(B, device=v.device)[:, None, None, None]
    pts = v[bi, corners]  # [B, s, s, 3, 3]
    at = attrs[bi, corners]  # [B, s, s, 3, C]
    px, py, z = project(pts, s)
    Y, X = torch.meshgrid(torch.arange(s, device=v.device, dtype=v.dtype),
                          torch.arange(s, device=v.device, dtype=v.dtype), indexing="ij")
    co, _, _ = candidate(px, py, z, X[None], Y[None], s, eps)
    co = torch.where(valid[..., None], co, torch.zeros_like(co))[..., None]
    return (co[..., 0, :] * at[..., 0, :] + co[..., 1, :] * at[..., 1, :]
            + co[..., 2, :] * at[..., 2, :])


def pyramid(v, attrs, tri, sizes, eps: float = 1e-6):
    """``[(values [B, s, s, C], winners [B, s, s])]`` for each size."""
    out = []
    for s in sizes:
        win = winners(v, tri, s, eps)
        out.append((interpolate(v, attrs, tri, win, s, eps), win))
    return out
