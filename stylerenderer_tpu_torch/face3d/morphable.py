"""Statistical face geometry models (counterpart of
``stylerenderer_tpu/face3d/morphable.py``): PCA (``LinearMorphableModel``,
BFM), bilinear blendshapes (``BlendShapeModel``, FaceWarehouse) and linear
blend skinning (``LinearBlendSkinningModel``, FLAME).

Each has ``dim``, ``device``, ``random_input(batch_size, generator)``,
``__call__(x) -> [B, nv, 3]`` and ``regulation(x)``. Their arrays are built
in numpy from the same seeds as the JAX package's, so both hold the same
weights."""

from __future__ import annotations

import math

import numpy as np
import torch

from stylerenderer_tpu_torch.face3d.transforms import rodrigues
from stylerenderer_tpu_torch.utils.logging import trace_ctx


class LinearMorphableModel:
    """``v = x @ basis + mean``, reshaped to ``[B, nv, 3]``.

    ``basis`` ``[D, 3nv]``, ``mean`` ``[3nv]``, ``sigma`` ``[D]`` (the prior
    stddevs); ``D = shape_dim + expression_dim``.
    """

    def __init__(self, basis, mean, sigma, shape_dim: int, expression_dim: int):
        self.basis = basis
        self.mean = mean
        self.sigma = sigma
        self.shape_dim = shape_dim
        self.expression_dim = expression_dim

    @property
    def dim(self):
        return [self.shape_dim, self.expression_dim, self.mean.shape[-1]]

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def random_input(self, batch_size: int = 1,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """Samples from the prior, drawn on ``generator``'s device (the CPU
        without one; a CPU generator gives the same samples for any model
        device)."""
        gdev = generator.device if generator is not None else None
        x = torch.randn(batch_size, self.sigma.shape[0], generator=generator, device=gdev)
        return x.to(self.device) * self.sigma

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with trace_ctx("geometry.morph"):
            v = x @ self.basis + self.mean
            return v.reshape(x.shape[0], -1, 3)

    def regulation(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum((x / self.sigma[None, :]) ** 2)


def make_linear_morphable_model(vertices_num: int, shape_dim: int = 0,
                                expression_dim: int = 0, vertices_mean=None,
                                w_shape=None, w_expression=None,
                                sigma_shape=1.0, sigma_expression=0.01,
                                seed: int = 0, device=None) -> LinearMorphableModel:
    """Build a ``LinearMorphableModel``, filling missing pieces with a
    seeded random-uniform initialization (numpy, so the arrays equal the
    JAX package's for the same arguments)."""
    rng = np.random.RandomState(seed)
    d = shape_dim + expression_dim
    mean = (rng.rand(vertices_num * 3).astype(np.float32) * 2 - 1) * np.sqrt(max(d, 1))
    basis = (rng.rand(d, vertices_num * 3).astype(np.float32) * 2 - 1) * np.sqrt(max(d, 1))
    if vertices_mean is not None:
        vm = np.asarray(vertices_mean, np.float32)
        if vm.shape[0] == 3 and vm.ndim > 1:
            vm = vm.reshape(3, -1).T
        vm = vm.reshape(-1, 3)
        n = min(vertices_num, vm.shape[0])
        mean[: 3 * n] = vm[:n].reshape(-1)
    for w_in, off, dd in ((w_shape, 0, shape_dim),
                          (w_expression, shape_dim, expression_dim)):
        if w_in is None or dd == 0:
            continue
        w_np = np.asarray(w_in, np.float32).reshape(-1, np.asarray(w_in).shape[-1])
        if w_np.shape[0] == basis.shape[1] and w_np.shape[1] >= dd:
            w_np = w_np.T
        k = min(dd, w_np.shape[0])
        n = min(vertices_num, w_np.shape[1] // 3)
        basis[off:off + k, : 3 * n] = w_np[:k, : 3 * n]

    sigma = np.concatenate([_expand(sigma_shape, shape_dim),
                            _expand(sigma_expression, expression_dim)])
    f32 = dict(dtype=torch.float32, device=device)
    return LinearMorphableModel(
        basis=torch.as_tensor(basis, **f32),
        mean=torch.as_tensor(mean, **f32),
        sigma=torch.as_tensor(sigma, **f32),
        shape_dim=shape_dim, expression_dim=expression_dim)


def _draw_device(generator: torch.Generator | None) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


def log_gamma(alpha: torch.Tensor, batch_size: int,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """``log`` of Gamma(``alpha``, 1) draws, ``[batch_size, K]`` for
    ``alpha`` ``[K]``, on ``generator``'s device (the CPU without one).

    Marsaglia and Tsang's rejection method, written on ``torch.randn`` and
    ``torch.rand`` so that it draws from an explicit generator (the
    ``torch.distributions`` samplers take none): every round draws a normal
    and a uniform for each pending element until all are accepted. A shape
    below 1 is boosted, ``G(a) = G(a + 1) U^(1/a)``, and kept in log space,
    so a small shape gives a finite log where the variate itself would
    underflow (as the JAX package's ``loggamma``)."""
    dev = _draw_device(generator)
    a = alpha.detach().to(dev, torch.float32).expand(batch_size, -1).reshape(-1)
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    pending = torch.arange(a.numel(), device=dev)
    while pending.numel():
        dd, cc = d[pending], c[pending]
        x = torch.randn(pending.numel(), generator=generator, device=dev)
        u = torch.rand(pending.numel(), generator=generator, device=dev)
        v = (1.0 + cc * x) ** 3
        log_v = torch.log(torch.clamp(v, min=1e-30))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dd - dd * v + dd * log_v)
        out[pending[ok]] = (torch.log(dd) + log_v)[ok]
        pending = pending[~ok]
    u = torch.rand(a.numel(), generator=generator, device=dev)
    out = out + torch.where(boost, torch.log(u) / a, torch.zeros_like(a))
    return out.reshape(batch_size, -1)


class BlendShapeModel:
    """Bilinear identity x expression blendshapes (counterpart of the
    ``BlendShapeModel`` of ``stylerenderer_tpu/face3d/morphable.py``).

    ``weight`` ``[S+1, E+1, 3nv]``; ``beta`` ``[S+1 + 2E]``: the Dirichlet
    concentrations of the identity simplex, then a Beta (a, b) pair per
    expression. ``x[:, :S]`` are the identity logits (the last is minus
    their sum), ``x[:, S:]`` the expression logits."""

    def __init__(self, weight, beta, shape_dim: int, expression_dim: int):
        self.weight = weight
        self.beta = beta
        self.shape_dim = shape_dim
        self.expression_dim = expression_dim

    @property
    def dim(self):
        return [self.shape_dim, self.expression_dim, self.weight.shape[-1]]

    @property
    def device(self) -> torch.device:
        return self.weight.device

    def random_input(self, batch_size: int = 1, generator: torch.Generator | None = None,
                     eps: float = 1e-9) -> torch.Tensor:
        """Samples from the prior: identity weights from the Dirichlet, as
        log ratios to the last identity, centred; expression weights from
        the Betas, as logits. Drawn on ``generator``'s device (``log_gamma``),
        so a CPU generator gives the same samples for any model device. The
        ratios are taken in log space: they equal the JAX package's
        ``log(p / max(p_last, eps))`` wherever its f32 ``p`` does not
        underflow to 0 (there the JAX package gives ``-inf``)."""
        S, E = self.shape_dim, self.expression_dim
        beta = self.beta.detach().cpu()
        log_p = torch.log_softmax(log_gamma(beta[: S + 1], batch_size, generator), -1)
        xs = log_p[:, :-1] - torch.clamp(log_p[:, -1:], min=math.log(eps))
        ab = beta[S + 1:].reshape(E, 2)
        la = log_gamma(ab[:, 0], batch_size, generator)
        lb = log_gamma(ab[:, 1], batch_size, generator)
        lse = torch.logaddexp(la, lb)
        xe = (la - lse) - torch.clamp(lb - lse, min=math.log(eps))
        x = torch.cat([xs - torch.sum(xs, 1, keepdim=True) / S, xe], 1)
        return x.to(self.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        S, E = self.shape_dim, self.expression_dim
        xs = torch.softmax(torch.cat([x[:, :S], -torch.sum(x[:, :S], 1, keepdim=True)], 1), -1)
        xe = torch.sigmoid(x[:, S:])
        xe = torch.cat([1 - torch.sum(xe, 1, keepdim=True), xe], 1)
        mid = (xs @ self.weight.reshape(S + 1, -1)).reshape(-1, E + 1, self.dim[2])
        v = torch.einsum("be,bed->bd", xe, mid)
        return v.reshape(x.shape[0], -1, 3)

    def regulation(self, x: torch.Tensor) -> torch.Tensor:
        """The Dirichlet and Beta log-prior energy."""
        S = self.shape_dim
        xs = torch.cat([x[:, :S], -torch.sum(x[:, :S], 1, keepdim=True)], 1)
        xe = x[:, S:]
        alpha = self.beta[: S + 1]
        a_e = self.beta[S + 1:].reshape(-1, 2)
        term_s = torch.sum(xs * alpha[None, :]) - torch.sum(
            torch.log(torch.sum(torch.exp(xs), 1))) * (torch.sum(alpha) - S - 1)
        term_e = torch.sum(xe * a_e[None, :, 0] - 1) - torch.sum(
            torch.log(torch.exp(xe) + 1) * (torch.sum(a_e, 1)[None, :] - 2))
        return -(term_s + term_e)


def _expand(s, d: int, default: float = 1.0) -> np.ndarray:
    """``|s|`` flattened and padded to ``d`` entries with its last one
    (``default`` when empty)."""
    s = np.abs(np.reshape(s, -1)) if s is not None else np.zeros(0)
    return np.array([s[i] if len(s) > i else (s[-1] if len(s) else default)
                     for i in range(d)], np.float32)


def make_blendshape_model(vertices_num: int, shape_dim: int, expression_dim: int, bs=None,
                          beta_shape=1.0, beta_expression=(1.0, 10.0), seed: int = 0,
                          device=None) -> BlendShapeModel:
    """Build a ``BlendShapeModel`` from blendshapes ``bs`` ``[S', E', >=3nv]``
    (their overlap with the model's shape), filling the rest with a seeded
    random-uniform initialization (numpy, so the arrays equal the JAX
    package's for the same arguments)."""
    shape = (shape_dim + 1, expression_dim + 1, vertices_num * 3)
    if bs is not None:
        bs = np.asarray(bs, np.float32)
        bs = bs.reshape(bs.shape[0], bs.shape[1], -1)
        cut = (min(bs.shape[0], shape[0]), min(bs.shape[1], shape[1]),
               min((bs.shape[2] // 3) * 3, shape[2]))
    if bs is not None and cut == shape:
        # the blendshapes cover the model: the random fill would all be overwritten
        w = np.ascontiguousarray(bs[: shape[0], : shape[1], : shape[2]])
    else:
        rng = np.random.RandomState(seed)
        w = (rng.rand(*shape).astype(np.float32) * 2 - 1) * np.sqrt(
            max(shape_dim + expression_dim, 1))
        if bs is not None:
            w[: cut[0], : cut[1], : cut[2]] = bs[: cut[0], : cut[1], : cut[2]]
    bex = np.abs(np.reshape(beta_expression, -1))
    beta = np.concatenate([
        _expand(beta_shape, shape_dim + 1),
        np.array([bex[2 * i + j] if len(bex) > 2 * i + 1 else (bex[j - 2] if len(bex) > 1 else 1.0)
                  for i in range(expression_dim) for j in range(2)], np.float32)])
    f32 = dict(dtype=torch.float32, device=device)
    return BlendShapeModel(weight=torch.as_tensor(w, **f32), beta=torch.as_tensor(beta, **f32),
                           shape_dim=shape_dim, expression_dim=expression_dim)


class LinearBlendSkinningModel:
    """SMPL/FLAME-style linear blend skinning (counterpart of the
    ``LinearBlendSkinningModel`` of ``stylerenderer_tpu/face3d/morphable.py``):
    shape blendshapes, pose-corrective blendshapes, forward kinematics and
    skinning, in the row-vector convention (``p' = p @ R + t``).

    ``x[:, :S]`` are the shape coefficients, ``x[:, S:]`` the axis-angle
    rotations of joints 1..J-1 (``parents[i]`` is joint ``i + 1``'s parent;
    parents precede children)."""

    def __init__(self, shapedirs, posedirs, v_template, lbs_weights, j_regressor, sigma,
                 pose_mean, pose_cov, parents, shape_dim: int):
        self.shapedirs = shapedirs      # [S, 3nv]
        self.posedirs = posedirs        # [(J-1)*9, 3nv]
        self.v_template = v_template    # [3nv]
        self.lbs_weights = lbs_weights  # [nv, J]
        self.j_regressor = j_regressor  # [J, nv]
        self.sigma = sigma              # [S + (J-1)*3]
        self.pose_mean = pose_mean      # [(J-1)*3]
        self.pose_cov = pose_cov        # [J-1, 3, 3]
        self.parents = tuple(parents)
        self.shape_dim = shape_dim

    @property
    def dim(self):
        return [self.shape_dim, len(self.parents) * 3, self.v_template.shape[-1]]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def random_input(self, batch_size: int = 1,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """Shape coefficients from N(0, sigma^2); per-joint rotations from
        N(pose_mean, pose_cov^T pose_cov). Drawn on ``generator``'s device
        (the CPU without one), so a CPU generator gives the same samples for
        any model device."""
        x = torch.randn(batch_size, self.sigma.shape[0], generator=generator,
                        device=_draw_device(generator)).to(self.device) * self.sigma
        pose = x[:, self.shape_dim:].reshape(batch_size, -1, 3)
        pose = torch.einsum("bji,jik->bjk", pose, self.pose_cov) + self.pose_mean.reshape(1, -1, 3)
        return torch.cat([x[:, : self.shape_dim], pose.reshape(batch_size, -1)], 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[0], self.shape_dim
        nv = self.v_template.shape[-1] // 3
        v_shaped = x[:, :S] @ self.shapedirs + self.v_template
        R = rodrigues(x[:, S:].reshape(B, -1, 3))  # [B, J-1, 3, 3]
        J3 = torch.einsum("jn,bnk->bjk", self.j_regressor, v_shaped.reshape(B, nv, 3))
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        v_posed = ((R - eye).reshape(B, -1) @ self.posedirs + v_shaped).reshape(B, nv, 3)
        # forward kinematics, root first
        rots, trans = [eye.expand(B, 3, 3)], [J3[:, 0]]
        for i, p in enumerate(self.parents):
            rots.append(torch.einsum("bij,bjk->bik", R[:, i].transpose(1, 2), rots[p]))
            trans.append(torch.einsum("bk,bkj->bj", J3[:, i + 1] - J3[:, p], rots[p]) + trans[p])
        Rg, Tg = torch.stack(rots, 1), torch.stack(trans, 1)  # [B, J, 3, 3], [B, J, 3]
        # skinning
        vj = (torch.einsum("bnk,bjkl->bjnl", v_posed, Rg)
              - torch.einsum("bjk,bjkl->bjl", J3, Rg)[:, :, None, :] + Tg[:, :, None, :])
        return torch.einsum("nj,bjnk->bnk", self.lbs_weights, vj)

    def regulation(self, x: torch.Tensor) -> torch.Tensor:
        """The shape prior plus the Mahalanobis pose prior."""
        S = self.shape_dim
        l_shape = torch.sum((x[:, :S] / self.sigma[None, :S]) ** 2)
        pose = x[:, S:].reshape(x.shape[0], -1, 3)
        proj = torch.einsum("bji,jik->bjk", pose, torch.linalg.inv(self.pose_cov))
        return l_shape + torch.sum(proj ** 2)


def make_lbs_model(vertices_num: int, pose_nodes: int, shape_dim: int, v_template=None,
                   j_regressor=None, parents=None, weights=None, posedirs=None, shapedirs=None,
                   sigma_shape=1.0, sigma_pose=1.0, mean_pose=0.0, seed: int = 0,
                   device=None) -> LinearBlendSkinningModel:
    """Build a ``LinearBlendSkinningModel``, filling missing pieces with a
    seeded random-uniform initialization and, without ``weights``, a
    nearest-joint soft assignment (numpy, so the arrays equal the JAX
    package's for the same arguments)."""
    rng = np.random.RandomState(seed)
    nj = max(pose_nodes, 1)
    scale = np.sqrt(shape_dim + (nj - 1) * 9)
    vt = (rng.rand(vertices_num * 3).astype(np.float32) * 2 - 1) * scale
    sd = (rng.rand(shape_dim, vertices_num * 3).astype(np.float32) * 2 - 1) * scale
    pd = (rng.rand((nj - 1) * 9, vertices_num * 3).astype(np.float32) * 2 - 1) * scale
    jr = (rng.rand(nj, vertices_num).astype(np.float32) * 2 - 1) * np.sqrt(nj)
    if v_template is not None:
        v_np = np.asarray(v_template, np.float32).reshape(-1, 3)
        n = min(vertices_num, v_np.shape[0])
        vt[: 3 * n] = v_np[:n].reshape(-1)
    if shapedirs is not None:
        s_np = np.asarray(shapedirs, np.float32).reshape(-1, np.asarray(shapedirs).shape[-1])
        if s_np.shape[0] == vertices_num * 3 and s_np.shape[1] >= shape_dim:
            s_np = s_np.T
        d = min(shape_dim, s_np.shape[0])
        sd[:d] = s_np[:d, : vertices_num * 3]
    if posedirs is not None:
        p_np = np.asarray(posedirs, np.float32).reshape(-1, np.asarray(posedirs).shape[-1])
        if p_np.shape[0] == vertices_num * 3 and p_np.shape[1] >= (nj - 1) * 9:
            p_np = p_np.T
        d = min((nj - 1) * 9, p_np.shape[0])
        pd[:d] = p_np[:d, : vertices_num * 3]
    if j_regressor is not None:
        j_np = np.asarray(j_regressor, np.float32)
        if j_np.shape[0] != nj:
            j_np = j_np.T
        jr[: j_np.shape[0], : j_np.shape[1]] = j_np[:nj, :vertices_num]
    parents = tuple(0 for _ in range(nj - 1)) if parents is None else tuple(
        int(p) for p in parents)
    if weights is not None:
        w_np = np.asarray(weights, np.float32)
        if w_np.shape[0] == nj and w_np.shape[1] >= vertices_num:
            w_np = w_np.T
        w = np.zeros((vertices_num, nj), np.float32)
        w[: w_np.shape[0], : w_np.shape[1]] = w_np[:vertices_num, :nj]
    else:
        J = jr.dot(vt.reshape(-1, 3))
        d2 = ((vt.reshape(-1, 3)[:, None] - J[None]) ** 2).sum(-1)
        idx = d2.argmin(1)
        w = np.zeros((vertices_num, nj), np.float32)
        dmax2 = d2.max() if d2.size else 1.0
        w[np.arange(vertices_num), idx] = np.exp(-d2[np.arange(vertices_num), idx] / dmax2)
    w = np.abs(w)
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-5)

    sigma = np.concatenate([_expand(sigma_shape, shape_dim), np.ones((nj - 1) * 3, np.float32)])
    mp = _expand(mean_pose, nj - 1, 0.0) if np.size(mean_pose) <= nj - 1 else _expand(
        mean_pose, (nj - 1) * 3, 0.0)
    if mp.shape[0] == nj - 1:
        mp = np.repeat(mp, 3)
    sp = np.abs(np.reshape(sigma_pose, -1))
    if len(sp) <= nj - 1:
        cov = np.stack([(sp[i] if len(sp) > i else (sp[-1] if len(sp) else 1.0)) * np.eye(3)
                        for i in range(nj - 1)]).astype(np.float32)
    elif len(sp) <= (nj - 1) * 3:
        vals = _expand(sigma_pose, (nj - 1) * 3)
        cov = np.stack([np.diag(vals[3 * i: 3 * i + 3]) for i in range(nj - 1)]).astype(
            np.float32)
    else:
        cov = _expand(sigma_pose, (nj - 1) * 9).reshape(nj - 1, 3, 3).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return LinearBlendSkinningModel(
        shapedirs=torch.as_tensor(sd, **f32), posedirs=torch.as_tensor(pd, **f32),
        v_template=torch.as_tensor(vt, **f32), lbs_weights=torch.as_tensor(w, **f32),
        j_regressor=torch.as_tensor(jr, **f32), sigma=torch.as_tensor(sigma, **f32),
        pose_mean=torch.as_tensor(mp, **f32), pose_cov=torch.as_tensor(cov, **f32),
        parents=parents, shape_dim=shape_dim)
