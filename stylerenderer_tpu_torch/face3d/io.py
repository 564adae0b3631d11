"""Face model loaders (BFM, FaceWarehouse, FLAME) and synthetic stand-ins
(counterpart of ``stylerenderer_tpu/face3d/io.py``).

Each loader takes a file path or the dict that the file holds, and
returns ``(model, tri)``: the model's tensors and ``tri`` ``[nf, 3]``
int64 (0-based) on ``device``, the card unless the caller passes
``device="cpu"``. The arrays are built in numpy as the JAX
package builds them, so both packages hold the same weights for the same
file.
"""

from __future__ import annotations

import numpy as np
import torch

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.face3d.morphable import (
    make_blendshape_model,
    make_lbs_model,
    make_linear_morphable_model,
)


def _load_mat(file_name):
    if isinstance(file_name, str):
        import scipy.io as sio

        return sio.loadmat(file_name)
    return file_name


def _faces(tri, device) -> torch.Tensor:
    """Triangles from a file: a MATLAB cell is unwrapped, indices start at
    0, a ``[3, nf]`` table is transposed."""
    tri = np.asarray(tri[0, 0] if tri.dtype == object else tri)
    tri = (tri - tri.min()).astype(np.int32)
    if tri.shape[0] == 3 and tri.shape[1] != 3:
        tri = tri.T
    return torch.as_tensor(tri, device=device).long()


def load_bfm(file_name, device="cuda"):
    """Basel Face Model ``.mat`` (or its dict) -> (``LinearMorphableModel``,
    tri). Keys: ``v`` ``[3, nv]`` in BFM units (scaled by 1e-5 and centred
    here), ``w_shape`` ``[3nv, S]`` and ``w_exp`` ``[3nv, E]`` (scaled by
    1e-5 and, where ``sigma_shape`` / ``sigma_exp`` are given, multiplied
    by them column by column), ``tri`` (1-based, ``[3, nf]`` or
    ``[nf, 3]``, maybe a MATLAB cell)."""
    device = resolve_device(device)
    data = _load_mat(file_name)
    v = np.asarray(data["v"], np.float64)
    v = (v - v.mean(1).reshape(-1, 1)).T * 1e-5
    w_shape = np.asarray(data["w_shape"]) * 1e-5
    w_exp = np.asarray(data["w_exp"]) * 1e-5
    if "sigma_shape" in data:
        w_shape = w_shape.dot(np.diag(np.asarray(data["sigma_shape"]).reshape(-1)))
    if "sigma_exp" in data:
        w_exp = w_exp.dot(np.diag(np.asarray(data["sigma_exp"]).reshape(-1)))
    model = make_linear_morphable_model(len(v), w_shape.shape[1], w_exp.shape[1], v,
                                        w_shape, w_exp, device=device)
    return model, _faces(np.asarray(data["tri"]), device)


def load_bfm_texture(file_name) -> np.ndarray | None:
    """The mean face's per-vertex texture ``tex`` of a BFM ``.mat`` (or its
    dict) as ``[nv, 3]`` f32 in [0, 255]; None if it has none. The
    canonical alignment reference renders it (``align --render_ref``)."""
    data = _load_mat(file_name)
    if "tex" not in data:
        return None
    tex = np.asarray(data["tex"], np.float32)
    if tex.shape[0] == 3 and tex.shape[1] != 3:
        tex = tex.T
    return tex


def load_facewarehouse(file_name, device="cuda"):
    """FaceWarehouse bilinear tensor ``.mat`` (or its dict) ->
    (``BlendShapeModel``, tri). Keys: ``v`` ``[3, nv]``, ``p``
    ``[3nv, E+1, S+1]`` (centred on ``v``'s mean position here), ``tri``.
    The identity prior is a Dirichlet of concentration 0.01."""
    device = resolve_device(device)
    data = _load_mat(file_name)
    v = np.asarray(data["v"])
    p = np.asarray(data["p"])
    v_mean = np.tile(v.mean(1).reshape(-1, 1, 1), (v.shape[1], 1, 1))
    bs = np.transpose(p - v_mean, (2, 1, 0))
    model = make_blendshape_model(v.shape[1], bs.shape[0] - 1, bs.shape[1] - 1, bs, 0.01,
                                  device=device)
    return model, _faces(np.asarray(data["tri"]), device)


def _order_kintree(kintree, pose_nodes):
    """Reorder joints so that every parent precedes its children: ->
    (the new parent index of each non-root joint, the order). A parent
    below 0 or at least ``pose_nodes`` marks a root (FLAME writes
    4294967295)."""
    kt = np.asarray(kintree, np.int64)
    if kt.ndim == 1:
        if len(kt) == pose_nodes - 1:
            kt = np.concatenate([[-1], kt])
        kt = np.vstack([kt, np.arange(pose_nodes)])
    elif kt.shape[1] == 2 and kt.shape[0] == pose_nodes:
        kt = kt.T
    roots = list(kt[1, (kt[0] < 0) | (kt[0] >= pose_nodes)])
    order = list(roots)
    i = 0
    while len(order) < pose_nodes:
        order += list(kt[1, kt[0] == order[i]])
        i += 1
    inv = np.zeros(pose_nodes, np.int64)
    inv[np.asarray(order)] = np.arange(pose_nodes)
    parent_of = {int(c): int(p) for p, c in kt.T if 0 <= p < pose_nodes}
    parents = [int(inv[parent_of[int(order[k])]]) for k in range(len(roots), pose_nodes)]
    return parents, np.asarray(order)


def load_flame(file_name, device="cuda"):
    """FLAME ``.pkl`` / ``.mat`` (or its dict) -> (``LinearBlendSkinningModel``,
    tri). Keys: ``v_template`` ``[nv, 3]``, ``shapedirs`` ``[nv, 3, S]``,
    ``posedirs`` ``[nv, 3, (J-1)*9]``, ``kintree_table``, ``J_regressor``
    ``[J, nv]`` (dense or scipy sparse), ``weights`` ``[nv, J]``, ``f``.
    Joints are reordered parents first; the neck, jaw and eye pose priors
    are given in degrees. A published ``.pkl`` holds ``chumpy`` arrays,
    which unpickling needs importable."""
    device = resolve_device(device)
    if isinstance(file_name, str) and file_name.endswith(".pkl"):
        import pickle

        with open(file_name, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = _load_mat(file_name)
    v_template = np.asarray(data["v_template"])
    posedirs = np.asarray(data["posedirs"])
    shapedirs = np.asarray(data["shapedirs"])
    nj = posedirs.shape[-1] // 9 + 1
    nv = v_template.shape[0]
    parents, order = _order_kintree(data["kintree_table"], nj)
    jr = data["J_regressor"]
    jr = np.asarray(jr.todense()) if hasattr(jr, "todense") else np.asarray(jr)
    if jr.shape[0] != nj:
        jr = jr.T
    weights = np.asarray(data["weights"])
    if weights.shape[0] == nj:
        weights = weights.T
    jr = jr[order]
    weights = weights[:, order]
    # posedirs' columns follow the file's joints 1..J-1: take them in the new
    # order, without the root
    col = np.asarray([o - 1 for o in order if o != order[0]])
    pd = posedirs.reshape(nv * 3, nj - 1, 9)[:, col, :].reshape(nv * 3, (nj - 1) * 9)
    neck, jaw, eye = [10, 30, 5], [10, 1, 1], [10, 10, 1e-5]
    sigma_pose = [s * np.pi / 180 for s in neck + jaw + eye + eye]
    model = make_lbs_model(
        nv, nj, shapedirs.shape[-1], v_template=v_template, j_regressor=jr, parents=parents,
        weights=weights, posedirs=pd.T,
        shapedirs=shapedirs.reshape(-1, shapedirs.shape[-1]).T, sigma_shape=1.0,
        sigma_pose=sigma_pose, device=device)
    return model, _faces(np.asarray(data["f"]), device)


def sphere_face_mesh(nu: int = 64, nv: int = 128, radius: float = 0.6):
    """A UV-sphere 'face' mesh (numpy): verts ``[N, 3]`` f32, tri ``[M, 3]`` i32."""
    th = np.linspace(1e-3, np.pi - 1e-3, nu)
    ph = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([radius * np.sin(T) * np.cos(P), radius * np.cos(T),
                    radius * np.sin(T) * np.sin(P)], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(nu * nv).reshape(nu, nv)
    tris = []
    for i in range(nu - 1):
        a = idx[i]
        b = np.roll(idx[i], -1)
        c = np.roll(idx[i + 1], -1)
        d = idx[i + 1]
        tris.append(np.stack([a, b, c], -1))
        tris.append(np.stack([a, c, d], -1))
    return pts, np.concatenate(tris).astype(np.int32)


def synthetic_face(nu: int = 64, nv: int = 128, shape_dim: int = 80,
                   expression_dim: int = 29, seed: int = 0, device=None):
    """A BFM-shaped synthetic morphable model over a sphere-face mesh: the
    mean is the sphere, the basis smooth random sinusoidal fields.
    Returns (model, tri ``[nf, 3]`` int64 on ``device``)."""
    pts, tri = sphere_face_mesh(nu, nv)
    rng = np.random.RandomState(seed)
    d = shape_dim + expression_dim
    freqs = rng.uniform(0.5, 3.0, (d, 3)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (d, 1)).astype(np.float32)
    dirs = rng.randn(d, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    field = np.sin(pts @ (freqs.T * np.pi) + phases.T)  # [n, d]
    basis = (field.T[:, :, None] * dirs[:, None, :] * 0.05).astype(np.float32)
    basis = basis.reshape(d, -1)
    model = make_linear_morphable_model(pts.shape[0], shape_dim, expression_dim, pts,
                                        basis[:shape_dim], basis[shape_dim:],
                                        device=device)
    return model, torch.as_tensor(tri, device=device).long()


def load_face_model(bfm: str = "", device="cuda"):
    """The CLIs' face model: the BFM file ``bfm`` (``load_bfm``) or, without
    one, ``synthetic_face(48, 96, 80, 29)`` (9,024 triangles)."""
    device = resolve_device(device)
    return load_bfm(bfm, device=device) if bfm else synthetic_face(48, 96, 80, 29,
                                                                   device=device)
