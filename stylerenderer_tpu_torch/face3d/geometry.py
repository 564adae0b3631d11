"""Mesh geometry: per-vertex normals, rigid pose augmentation and OBJ
export (counterpart of ``stylerenderer_tpu/face3d/geometry.py``)."""

from __future__ import annotations

import os

import numpy as np
import torch

from stylerenderer_tpu_torch.face3d.transforms import euler_mat
from stylerenderer_tpu_torch.utils.logging import trace_ctx


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalize with a clamped norm, ``v / sqrt(max(|v|^2, eps^2))``;
    the clamp inside the sqrt keeps gradients finite at zero vectors."""
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=eps * eps))


def mesh_point_normal(v: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals: ``v`` ``[B, nv, 3]`` (or
    ``[nv, 3]``), ``tri`` ``[nf, 3]``. Face normals (cross products, twice
    the area) are summed into their corners with ``index_add_``."""
    with trace_ctx("geometry.normals"):
        tri = torch.as_tensor(tri, device=v.device).long()
        va = v[..., tri[:, 0], :]
        vb = v[..., tri[:, 1], :]
        vc = v[..., tri[:, 2], :]
        fn = torch.linalg.cross(vb - va, vc - va, dim=-1)
        vn = torch.zeros_like(v)
        for j in range(3):
            vn = vn.index_add(-2, tri[:, j], fn)
        return normalize(vn)


POSE3D_P = (0.5, 0.1, 0.05, 0.1, 0.1, 0.1, 0.15)


def pose3D_draws(generator: torch.Generator | None, batch: int, p=POSE3D_P) -> torch.Tensor:
    """The pose draw of ``random_apply_pose3D``: N(0, 1) ``[batch, 7]``
    scaled by the stddevs ``p`` (zeros where ``p`` has fewer than 7), on
    the generator's device (the CPU without one)."""
    p = torch.as_tensor(p, dtype=torch.float32).reshape(-1)[:7].abs()
    if p.shape[0] < 7:
        p = torch.cat([p, torch.zeros(7 - p.shape[0])])
    gdev = generator.device if generator is not None else None
    return torch.randn(batch, 7, generator=generator, device=gdev) * p.to(gdev)[None, :]


def apply_pose3D(v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The rigid transform of the pose ``z`` ``[B, 7]`` (yaw, pitch, roll,
    tx, ty, tz, log-scale): ``v @ (exp(s) R) + t`` (row vectors)."""
    with trace_ctx("geometry.pose"):
        z = z.to(v.device)
        R = torch.exp(z[:, -1])[:, None, None] * euler_mat(z[:, :3], "yxz")
        t = z[:, 3:6]
        return torch.einsum("bnk,bkj->bnj", v[..., :3], R) + t[:, None, :]


def random_apply_pose3D(generator: torch.Generator | None, v: torch.Tensor,
                        p=POSE3D_P) -> torch.Tensor:
    """Random rigid transform of ``v`` ``[B, nv, 3]``: ``p`` are the stddevs
    of (yaw, pitch, roll, tx, ty, tz, log-scale); ``v @ R + t`` (row
    vectors)."""
    batch = v.shape[0] if v.ndim >= 3 else 1
    return apply_pose3D(v, pose3D_draws(generator, batch, p))


def save_obj(file_name, v, tri=(), vn=()):
    """Minimal OBJ writer: vertices, optional vertex normals, faces (1-based,
    ``f i//i`` with normals). Numpy in, the same bytes as the JAX
    package's writer."""
    v = np.asarray(v)
    tri = np.asarray(tri) if len(tri) else np.zeros((0, 3), np.int64)
    vn = np.asarray(vn) if len(vn) else None
    with open(file_name, "w") as f:
        for p in v:
            f.write("v " + " ".join("%f" % x for x in p) + "\n")
        if vn is not None:
            for n in vn:
                f.write("vn " + " ".join("%f" % x for x in n[:3]) + "\n")
        for t in tri:
            if vn is not None:
                f.write("f " + " ".join("%d//%d" % (i + 1, i + 1) for i in t) + "\n")
            else:
                f.write("f " + " ".join("%d" % (i + 1) for i in t) + "\n")
    return os.path.exists(file_name)
