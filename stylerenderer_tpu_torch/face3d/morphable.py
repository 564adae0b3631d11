"""PCA morphable face model (counterpart of the ``LinearMorphableModel`` of
``stylerenderer_tpu/face3d/morphable.py``)."""

from __future__ import annotations

import numpy as np
import torch


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

    def expand_sigma(s, dd):
        s = np.abs(np.reshape(s, -1)) if s is not None else np.zeros(0)
        out = np.ones(dd, np.float32)
        for i in range(dd):
            out[i] = s[i] if len(s) > i else (s[-1] if len(s) else 1.0)
        return out

    sigma = np.concatenate([expand_sigma(sigma_shape, shape_dim),
                            expand_sigma(sigma_expression, expression_dim)])
    f32 = dict(dtype=torch.float32, device=device)
    return LinearMorphableModel(
        basis=torch.as_tensor(basis, **f32),
        mean=torch.as_tensor(mean, **f32),
        sigma=torch.as_tensor(sigma, **f32),
        shape_dim=shape_dim, expression_dim=expression_dim)
