"""Face-model files in the published layouts (BFM, FaceWarehouse, FLAME),
made with numpy from seeds over UV-sphere meshes: no face model is in the
repository, so the loaders' tests and ``chip_smoke.py`` build these.

Shared by the CPU tests (which hand the same dicts or ``.mat`` files to
both packages), the card tests and ``chip_smoke.py``; imports neither JAX
nor torch."""

import numpy as np

# FLAME's kinematic tree: the global joint (root, parent 2^32 - 1), the neck
# under it, the jaw and both eyes under the neck
FLAME_KINTREE = np.asarray([[4294967295, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.uint32)


def sphere(nu, nv, radius=0.6):
    """UV-sphere points ``[nu * nv, 3]`` and triangles ``[nf, 3]`` (the
    layout of ``sphere_face_mesh``)."""
    th = np.linspace(1e-3, np.pi - 1e-3, nu)
    ph = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([radius * np.sin(T) * np.cos(P), radius * np.cos(T),
                    radius * np.sin(T) * np.sin(P)], -1).reshape(-1, 3)
    idx = np.arange(nu * nv).reshape(nu, nv)
    tri = []
    for i in range(nu - 1):
        a, b = idx[i], np.roll(idx[i], -1)
        c, d = np.roll(idx[i + 1], -1), idx[i + 1]
        tri += [np.stack([a, b, c], -1), np.stack([a, c, d], -1)]
    return pts.astype(np.float32), np.concatenate(tri).astype(np.int32)


def smooth_fields(rng, pts, k, amp):
    """``k`` smooth displacement fields ``[n, 3, k]``: sinusoids of the
    position (at most 3 cycles across the mesh) along random directions."""
    freqs = rng.uniform(0.5, 3.0, (k, 3)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
    dirs = rng.randn(k, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    field = np.sin(pts @ (freqs.T * np.pi) + phases)  # [n, k]
    return (field[:, None, :] * dirs.T[None] * amp).astype(np.float32)


def bfm_dict(nu=12, nv=24, shape_dim=6, exp_dim=3, seed=0, cell_tri=False):
    """A Basel Face Model ``.mat``'s keys: ``v`` ``[3, n]`` in BFM units
    (1e5 per unit, off-centre), ``w_shape`` ``[3n, S]`` (to be multiplied by
    ``sigma_shape``), ``w_exp`` ``[3n, E]``, ``sigma_shape`` ``[S, 1]``,
    ``tri`` ``[3, nf]`` 1-based (a 1 x 1 cell around it when
    ``cell_tri``), ``tex`` ``[3, n]`` in 0..255."""
    rng = np.random.RandomState(seed)
    pts, tri = sphere(nu, nv)
    n = len(pts)
    sigma = rng.uniform(0.5, 2.0, shape_dim).astype(np.float32)
    w_shape = smooth_fields(rng, pts, shape_dim, 0.05e5).reshape(3 * n, shape_dim) / sigma
    w_exp = smooth_fields(rng, pts, exp_dim, 0.02e5).reshape(3 * n, exp_dim)
    tex = np.clip(128 + 100 * smooth_fields(rng, pts, 3, 1.0).sum(-1), 0, 255)
    tri1 = (tri.T + 1).astype(np.float64)
    if cell_tri:
        cell = np.empty((1, 1), object)
        cell[0, 0] = tri1
        tri1 = cell
    return {"v": ((pts + np.asarray([0.01, -0.02, 0.03], np.float32)) * 1e5).T.astype(np.float64),
            "w_shape": w_shape, "w_exp": w_exp, "sigma_shape": sigma[:, None],
            "tri": tri1, "tex": tex.T.astype(np.float32)}


def facewarehouse_dict(nu=8, nv=12, n_id=5, n_exp=4, seed=0):
    """A FaceWarehouse ``.mat``'s keys: ``v`` ``[3, n]``, the bilinear
    tensor ``p`` ``[3n, n_exp, n_id]`` (identity and expression fields
    added to the mean), ``tri`` ``[nf, 3]`` 1-based."""
    rng = np.random.RandomState(seed)
    pts, tri = sphere(nu, nv)
    n = len(pts)
    ids = smooth_fields(rng, pts, n_id, 0.05).reshape(3 * n, n_id)
    exps = smooth_fields(rng, pts, n_exp, 0.02).reshape(3 * n, n_exp)
    p = pts.reshape(-1)[:, None, None] + ids[:, None, :] + exps[:, :, None]
    return {"v": pts.T.copy(), "p": p.astype(np.float32), "tri": tri + 1}


def flame_dict(nu=8, nv=12, shape_dim=10, seed=0, kintree=FLAME_KINTREE, sparse=False):
    """A FLAME model's keys: ``v_template`` ``[n, 3]``, ``shapedirs``
    ``[n, 3, S]``, ``posedirs`` ``[n, 3, 36]`` (4 joints below the root),
    ``kintree_table``, ``J_regressor`` ``[5, n]`` (rows summing to 1; a
    scipy CSC matrix when ``sparse``), ``weights`` ``[n, 5]`` (rows summing
    to 1), ``f`` ``[nf, 3]`` 0-based."""
    rng = np.random.RandomState(seed)
    pts, tri = sphere(nu, nv, 0.1)
    n = len(pts)
    jr = rng.rand(5, n) * (rng.rand(5, n) < 0.2)
    jr[:, 0] += 1e-3
    jr /= jr.sum(1, keepdims=True)
    weights = rng.rand(n, 5) ** 4
    weights /= weights.sum(1, keepdims=True)
    if sparse:
        import scipy.sparse

        jr = scipy.sparse.csc_matrix(jr)
    return {"v_template": pts.astype(np.float64),
            "shapedirs": smooth_fields(rng, pts, shape_dim, 0.01).astype(np.float64),
            "posedirs": smooth_fields(rng, pts, 36, 0.002).astype(np.float64),
            "kintree_table": kintree, "J_regressor": jr, "weights": weights,
            "f": tri.astype(np.uint32)}
