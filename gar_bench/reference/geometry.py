"""Plain face geometry for the benchmark's check: the linear morphable
model, the two rigid poses (the generation path's Euler pose and the
inversion's axis-angle pose) and area-weighted vertex normals.

``rnd`` rounds the inputs of every matrix product; the check runs it as the
identity, the control as a lower precision (``reference/lowp.py``).
"""

from __future__ import annotations

import torch


def _same(t):
    return t


def morph(x, basis, mean, rnd=_same):
    """``x @ basis + mean`` -> vertices ``[B, nv, 3]``."""
    v = rnd(x) @ rnd(basis) + mean
    return v.reshape(x.shape[0], -1, 3)


def _rot(axis: str, c, s):
    o, i = torch.zeros_like(c), torch.ones_like(c)
    rows = {"x": [i, o, o, o, c, -s, o, s, c],
            "y": [c, o, s, o, i, o, -s, o, c],
            "z": [c, -s, o, s, c, o, o, o, i]}[axis]
    return torch.stack(rows, -1).reshape(-1, 3, 3)


def euler_pose(v, z, rnd=_same):
    """The pose ``z`` ``[B, 7]`` (yaw, pitch, roll, tx, ty, tz, log-scale)
    applied to row vectors: ``v @ (exp(s) R) + t`` with ``R = Rz Rx Ry``
    (Euler order y, x, z)."""
    a = z[:, :3]
    c, s = torch.cos(a), torch.sin(a)
    R = None
    for n, axis in enumerate("yxz"):
        Rn = _rot(axis, c[:, n], s[:, n])
        R = Rn if R is None else Rn @ R
    R = torch.exp(z[:, 6])[:, None, None] * R
    return rnd(v) @ rnd(R) + z[:, None, 3:6]


def rodrigues(r, eps: float = 1e-8):
    """Axis-angle ``[B, 3]`` -> rotation ``[B, 3, 3]`` (series near 0)."""
    r2 = torch.sum(r * r, -1)
    small = r2 <= eps * eps
    r2s = torch.where(small, torch.ones_like(r2), r2)
    n = torch.sqrt(r2s)
    c = torch.where(small, 1.0 - r2 / 2 + r2 * r2 / 24, torch.cos(n))
    sc = torch.where(small, 1.0 - r2 / 6, torch.sin(n) / n)
    cc = torch.where(small, 0.5 - r2 / 24, (1.0 - torch.cos(n)) / r2s)
    o = torch.zeros_like(r[:, 0])
    K = torch.stack([o, -r[:, 2], r[:, 1], r[:, 2], o, -r[:, 0], -r[:, 1], r[:, 0], o],
                    -1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return (c[:, None, None] * eye + cc[:, None, None] * (r[:, :, None] * r[:, None, :])
            + sc[:, None, None] * K)


def axis_angle_pose(v, rvec, tvec, log_scale, rnd=_same):
    """``exp(log_scale) * v @ R(rvec) + tvec`` (row vectors)."""
    return (torch.exp(log_scale)[:, :, None] * (rnd(v) @ rnd(rodrigues(rvec)))
            + tvec[:, None, :])


def normals(v, tri):
    """Unit vertex normals: each face's cross product (twice its area)
    summed into its three corners, then normalised with the norm clamped
    at 1e-8."""
    tri = tri.long()
    a, b, c = v[:, tri[:, 0]], v[:, tri[:, 1]], v[:, tri[:, 2]]
    fn = torch.linalg.cross(b - a, c - a, dim=-1)
    vn = torch.zeros_like(v)
    for j in range(3):
        vn = vn.index_add(1, tri[:, j], fn)
    n2 = torch.sum(vn * vn, -1, keepdim=True)
    return vn / torch.sqrt(torch.clamp(n2, min=1e-16))
