"""3D transform builders (counterpart of
``stylerenderer_tpu/face3d/transforms.py``): homogeneous translation and
scale and the in-plane rotation in the row-vector layout (``p_h @ T``),
Euler angles and Rodrigues' formula."""

from __future__ import annotations

import torch


def translate_mat(t) -> torch.Tensor:
    """``[..., n]`` translation -> ``[..., n+1, n+1]`` homogeneous matrix laid
    out for row vectors, ``p_h @ T``: the translation is the last row."""
    t = torch.as_tensor(t)
    single = t.ndim == 1
    if single:
        t = t[None]
    b, n = t.shape
    mat = torch.eye(n + 1, dtype=t.dtype, device=t.device).repeat(b, 1, 1)
    mat[:, n, :n] = t
    return mat[0] if single else mat


def rotate_mat(theta) -> torch.Tensor:
    """Rotation about the image z-axis: angles ``[...]`` -> ``[..., 3, 3]``."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([c, -s, o, s, c, o, o, o, i], -1).reshape(theta.shape + (3, 3))


def scale_mat(s, dim: int | None = None) -> torch.Tensor:
    """Per-axis scales ``[..., n]`` (or isotropic ``[...]`` repeated ``dim``
    times) -> the homogeneous diagonal ``[..., n+1, n+1]``."""
    s = torch.as_tensor(s)
    if dim is not None and dim > 0:
        s = s[..., None].expand(s.shape + (dim,))
    d = torch.cat([s, torch.ones(s.shape[:-1] + (1,), dtype=s.dtype, device=s.device)], -1)
    return torch.diag_embed(d)


def euler_mat(angle: torch.Tensor, order: str = "yxz") -> torch.Tensor:
    """Euler angles ``[..., 3]`` -> rotation ``[..., 3, 3]``, composing
    R3 @ R2 @ R1 for the given axis order."""
    single = angle.ndim == 1
    if single:
        angle = angle[None]
    c, s = torch.cos(angle), torch.sin(angle)
    one = torch.ones_like(c[:, 0])
    zero = torch.zeros_like(c[:, 0])
    T = None
    for i in range(3):
        ci, si = c[:, i], s[:, i]
        ax = order[i].lower()
        if ax == "x":
            rows = [one, zero, zero, zero, ci, -si, zero, si, ci]
        elif ax == "y":
            rows = [ci, zero, si, zero, one, zero, -si, zero, ci]
        elif ax == "z":
            rows = [ci, -si, zero, si, ci, zero, zero, zero, one]
        else:
            continue
        R = torch.stack(rows, -1).reshape(-1, 3, 3)
        T = R if T is None else torch.einsum("bij,bjk->bik", R, T)
    return T[0] if single else T


def rodrigues(rvec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle ``[..., 3]`` -> rotation ``[..., 3, 3]``:
    ``cos(r) I + (1 - cos r)/r^2 rr^T + sin(r)/r [r]_x``, with Taylor series
    where ``r <= eps`` so the function and its derivatives of any order stay
    finite at r = 0."""
    single = rvec.ndim == 1
    if single:
        rvec = rvec[None]
    r2 = torch.sum(rvec * rvec, -1)
    small = r2 <= eps * eps
    # the sqrt sees 1 where the series is used, so its gradient stays finite
    r2_safe = torch.where(small, torch.ones_like(r2), r2)
    r = torch.sqrt(r2_safe)
    c = torch.where(small, 1.0 - r2 / 2 + r2 * r2 / 24, torch.cos(r))
    sc = torch.where(small, 1.0 - r2 / 6, torch.sin(r) / r)
    cc = torch.where(small, 0.5 - r2 / 24, (1.0 - torch.cos(r)) / r2_safe)
    rr = rvec[..., :, None] * rvec[..., None, :]
    zero = torch.zeros_like(rvec[..., 0])
    rx = torch.stack([zero, -rvec[..., 2], rvec[..., 1],
                      rvec[..., 2], zero, -rvec[..., 0],
                      -rvec[..., 1], rvec[..., 0], zero], -1).reshape(rvec.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = c[..., None, None] * eye + cc[..., None, None] * rr + sc[..., None, None] * rx
    return R[0] if single else R
