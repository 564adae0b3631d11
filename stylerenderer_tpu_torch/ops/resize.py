"""Linear image resize with antialiasing (counterpart of
``jax.image.resize(x, shape, "linear")``, which the JAX package's
``pyramid_mode="downsample"`` uses to build the normal-map pyramid).

JAX resizes each spatial axis by a weight matrix (``compute_weight_mat``
in ``jax/_src/image/scale.py``): a triangle kernel widened by
``max(1/scale, 1)`` (the antialias), sample positions
``(i + 0.5)/scale - 0.5``, every output column divided by its sum, so the
weights that fall outside the image are dropped and the edge pixels
renormalized rather than zero-padded. The port builds the same matrices
and applies both with one ``torch.einsum``: a plain product, as JAX leaves
it to XLA outside any kernel.
"""

from __future__ import annotations

import functools

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def linear_weights(n_in: int, n_out: int) -> torch.Tensor:
    """``[n_in, n_out]`` f32 weights (on the CPU) of one axis resized from
    ``n_in`` to ``n_out`` samples."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32)
    x = (sample[None, :] - src[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)  # the triangle kernel
    total = weights.sum(0, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS, weights / safe,
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@functools.lru_cache(maxsize=64)
def _weights_on(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype):
    """``linear_weights`` on ``device`` in ``dtype``, built once per shape
    (the constants that JAX's jit folds): rebuilding them per call cost the
    ``downsample`` pyramid a dozen small launches per level."""
    return linear_weights(n_in, n_out).to(device=device, dtype=dtype)


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``x`` ``[B, H, W, C]`` resized to ``[B, h, w, C]`` as
    ``jax.image.resize(x, (B, h, w, C), "linear")`` computes it (antialiased
    when shrinking). An axis whose size does not change is left alone, as
    in JAX."""
    wh = None if h == x.shape[1] else _weights_on(x.shape[1], h, x.device, x.dtype)
    ww = None if w == x.shape[2] else _weights_on(x.shape[2], w, x.device, x.dtype)
    if wh is not None and ww is not None:
        return torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)
    if wh is not None:
        return torch.einsum("bhwc,hH->bHwc", x, wh)
    if ww is not None:
        return torch.einsum("bhwc,wW->bhWc", x, ww)
    return x
