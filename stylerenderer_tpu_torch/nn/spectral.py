"""Spectral normalization and the dominant singular pair (counterpart of
``stylerenderer_tpu/nn/spectral.py``).

``SpectralNorm`` divides a weight by its top singular value, estimated by
power iteration (the ``u``/``v`` buffers) or exactly from the dominant
singular pair (``power_iterations=0``). The JAX package keeps ``u`` and
``v`` in a ``spectral`` variable collection that changes only when it is
applied with ``mutable``; here they are buffers that the power iteration
updates only in training mode (in eval mode the stored ``u`` and ``v``
give sigma, as ``torch.nn.utils.spectral_norm`` does). ``u`` and ``v``
are detached, as the JAX package's ``stop_gradient`` detaches them.
Autograd through ``torch.linalg.svd`` plays the part of the reference's
hand-written backward passes.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def normalize_vec(v: torch.Tensor, dim: int = -1, kind: str = "L2",
                  eps: float = 1e-8) -> torch.Tensor:
    """L2 / L1 / Linf normalization with a clamped norm. The L2 clamp is
    inside the sqrt, ``v / sqrt(max(|v|^2, eps^2))``: the same value as
    ``max(|v|, eps)``, with a finite gradient at ``v == 0``."""
    kind = kind.upper()
    if "L2" in kind:
        n2 = torch.sum(v * v, dim, keepdim=True)
        return v / torch.sqrt(torch.clamp(n2, min=eps * eps))
    if "L1" in kind:
        n = torch.sum(v, dim, keepdim=True)
    elif "LINF" in kind:
        n = torch.amax(torch.abs(v), dim, keepdim=True)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return v / torch.clamp(n, min=eps)


def batch_eigen_max(A: torch.Tensor):
    """Dominant singular pair of a batch of matrices: ``A`` ``[B, n, m]``
    -> (``u`` ``[B, n]`` with its sign fixed so that ``u[-1] >= 0``,
    ``sigma`` ``[B]``)."""
    u, s, _ = torch.linalg.svd(A, full_matrices=False)
    u0 = u[..., :, 0]
    flip = u0[..., -1:] < 0
    return torch.where(flip, -u0, u0), s[..., 0]


def spectral_sigma_exact(w: torch.Tensor) -> torch.Tensor:
    """Exact top singular value of ``w`` reshaped to ``[w.shape[0], -1]``."""
    m = w.reshape(w.shape[0], -1)
    if m.shape[0] > m.shape[1]:
        m = m.t()
    return batch_eigen_max(m[None])[1][0]


class _PowerIteration(nn.Module):
    """The ``weight_bar`` parameter, the ``u``/``v`` buffers and sigma."""

    def _init_spectral(self, weight_shape, power_iterations: int, eps: float):
        self.power_iterations, self.eps = power_iterations, eps
        self.weight_bar = nn.Parameter(torch.empty(weight_shape))
        height, width = weight_shape[0], math.prod(weight_shape[1:])
        if power_iterations > 0:
            self.register_buffer("u", torch.empty(height))
            self.register_buffer("v", torch.empty(width))

    def _reset_spectral(self, generator=None):
        with torch.no_grad():
            self.weight_bar.copy_(torch.randn(self.weight_bar.shape, generator=generator))
            if self.power_iterations > 0:
                self.u.copy_(normalize_vec(torch.randn(self.u.shape, generator=generator)))
                self.v.copy_(normalize_vec(torch.randn(self.v.shape, generator=generator)))

    def sigma(self) -> torch.Tensor:
        """The top singular value of ``weight_bar``; in training mode the
        power iteration first moves ``u`` and ``v`` (``power_iterations``
        rounds) and stores them."""
        w = self.weight_bar
        if self.power_iterations <= 0:
            return spectral_sigma_exact(w)
        w2d = w.reshape(w.shape[0], -1)
        u, v = self.u, self.v
        if self.training:
            with torch.no_grad():
                for _ in range(self.power_iterations):
                    v = normalize_vec(w2d.t() @ u, eps=self.eps)
                    u = normalize_vec(w2d @ v, eps=self.eps)
                self.u.copy_(u)
                self.v.copy_(v)
        return u @ (w2d @ v)


class SpectralNorm(_PowerIteration):
    """A ``weight_bar`` of ``weight_shape``, divided by its top singular
    value and handed to ``apply_fn(weight, *args)``."""

    def __init__(self, weight_shape, power_iterations: int = 1, eps: float = 1e-8):
        super().__init__()
        self._init_spectral(tuple(weight_shape), power_iterations, eps)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        self._reset_spectral(generator)

    def forward(self, apply_fn: Callable, *args):
        return apply_fn(self.weight_bar / self.sigma(), *args)


class SpectralEqualConv2d(_PowerIteration):
    """``EqualConv2d`` with a spectrally normalized weight, the reference's
    ``SpectralNorm(EqualConv2d(...))`` that ``ConvLayer(activate="sp")``
    builds: ``weight_bar`` ``[O, I, k, k]`` is divided by sigma, then scaled
    by ``1 / sqrt(I k k)``. Float32 whatever the caller's compute type, as
    in the JAX package."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 power_iterations: int = 1, eps: float = 1e-8):
        super().__init__()
        self._init_spectral((out_channel, in_channel, kernel_size, kernel_size),
                            power_iterations, eps)
        self.bias = nn.Parameter(torch.empty(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size * kernel_size)
        self.stride, self.padding = stride, padding
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        self._reset_spectral(generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        w = self.weight_bar / self.sigma() * self.scale
        return F.conv2d(x.to(w.dtype), w, self.bias, stride=self.stride, padding=self.padding)
