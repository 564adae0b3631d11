"""Fused bias-add + LeakyReLU + gain (counterpart of
``stylerenderer_tpu/ops/fused_act.py``), and the styled conv's whole
epilogue.

``leaky_relu(x + b, 0.2) * sqrt(2)`` with the bias broadcast over the
channel axis. The JAX package leaves this epilogue to XLA. Here
``fused_bias_act`` is the one entry point: it also takes the styled conv's
terms ahead of the bias (demodulation, FiLM, noise). Where autograd records
nothing, on a card, outside a ``spatial.sharded`` mesh, it is one
hand-written CUDA kernel (``csrc/fused_act.cu``): one read of the conv
output, one write of the activation, and no wait for the host. Otherwise it
is the plain chain, ``fused_bias_act_ref``, one PyTorch op a term. NCHW: the
channel axis defaults to 1.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from stylerenderer_tpu_torch.parallel import spatial

SQRT2 = math.sqrt(2.0)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's flags (csrc/fused_act.cuh) and type codes
_DEMOD, _FILM, _BIAS = 1, 2, 4
_DTYPE_CODES = {dtype: i for i, dtype in enumerate(KERNEL_DTYPES)}


def records(*tensors) -> bool:
    """Whether autograd records an op on ``tensors`` (``None`` entries
    skipped): grad mode on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def takes_kernel(x: torch.Tensor, *inputs) -> bool:
    """The dispatch rule of ``fused_bias_act``: ``x`` on a card in float32
    or bfloat16, autograd recording nothing on ``x`` and ``inputs``, and no
    ``spatial.sharded`` mesh active (its layers keep the plain chain)."""
    return (x.is_cuda and x.dtype in KERNEL_DTYPES and not records(x, *inputs)
            and spatial.active() is None)


def fused_bias_act(y: torch.Tensor, bias: torch.Tensor | None = None,
                   demod: torch.Tensor | None = None, film: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None, noise_weight: torch.Tensor | None = None,
                   negative_slope: float = 0.2, scale: float = SQRT2,
                   dim: int = 1) -> torch.Tensor:
    """``act(((y * demod) * film[:, 0] + film[:, 1]) + noise_weight * noise
    + bias)``, ``act(t) = leaky_relu(t, negative_slope) * scale``, each term
    optional: ``bias`` ``[C]`` along ``dim``; for an NCHW ``y`` (``dim`` 1)
    also ``demod`` ``[N, C]``, ``film`` ``[N, 2, H, W]`` and ``noise``
    ``[N or 1, 1, H or 1, W or 1]`` with ``noise_weight`` ``[1]``.

    ``takes_kernel`` decides: ``fused_bias_act_cuda``, else
    ``fused_bias_act_ref``."""
    if not takes_kernel(y, bias, demod, film, noise, noise_weight):
        return fused_bias_act_ref(y, bias, demod, film, noise, noise_weight, negative_slope,
                                  scale, dim)
    return fused_bias_act_cuda(y, bias, demod, film, noise, noise_weight, negative_slope, scale,
                               dim)


fused_bias_act.launches = 0


def fused_bias_act_ref(y, bias=None, demod=None, film=None, noise=None, noise_weight=None,
                       negative_slope: float = 0.2, scale: float = SQRT2, dim: int = 1):
    """The plain chain: one op a term, in the styled layers' order, each
    rounded to ``y``'s dtype; the gain a tensor of ``y``'s dtype."""
    if demod is not None:
        y = y * demod[:, :, None, None].to(y.dtype)
    if film is not None:
        y = y * film[:, 0:1] + film[:, 1:2]
    if noise is not None:
        y = y + noise_weight.to(y.dtype) * noise.to(y.device, y.dtype)
    if bias is not None:
        shape = [1] * y.ndim
        shape[dim] = bias.shape[0]
        y = y + bias.reshape(shape).to(y.dtype)
    return torch.where(y >= 0, y, y * negative_slope) * torch.tensor(
        scale, dtype=y.dtype, device=y.device)


@functools.lru_cache(maxsize=None)
def _gain(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype`` (sqrt 2 is 1.4140625 in bfloat16)."""
    return float(torch.tensor(scale, dtype=dtype))


def _layout(y, dim: int, pre: bool):
    """``y`` as the kernel walks it, ``(N, C, H, W)``, or ``None``: a
    contiguous ``y`` is ``[N, C, H, W]`` (``[N, C, P, 1]`` for another rank,
    ``P`` the axes after ``dim``); a channels-last NCHW ``y`` with no term
    ahead of the bias (the ResBlocks' convs give one, from the pyramid's
    ``[B, s, s, C]`` maps) is ``N * H * W`` rows of ``C``: ``[N * H * W, C, 1,
    1]``."""
    dim %= y.ndim
    if y.is_contiguous():
        rest = y.shape[dim + 1:]
        h, w = (rest[0], rest[1]) if len(rest) == 2 else (math.prod(rest), 1)
        return math.prod(y.shape[:dim]), y.shape[dim], h, w
    if y.ndim == 4 and dim == 1 and not pre and y.is_contiguous(
            memory_format=torch.channels_last):
        return y.shape[0] * y.shape[2] * y.shape[3], y.shape[1], 1, 1
    return None


def _kernel_args(y, bias, demod, film, noise, noise_weight, negative_slope, scale, dim):
    """Check the inputs for the kernel or its host build -> (out, the C
    function's arguments). ``y`` float32 or bfloat16, laid out as
    ``_layout`` takes it; the small terms float32; ``film`` of ``y``'s dtype,
    its planes dense; ``noise`` contiguous float32. ``out`` has
    ``y``'s layout. Raises on what the kernel does not take."""
    pre = demod is not None or film is not None or noise is not None
    if pre and (y.ndim != 4 or dim % y.ndim != 1):
        raise ValueError("demod, film and noise take an NCHW y with channels on dim 1")
    shape = _layout(y, dim, pre)
    if y.dtype not in KERNEL_DTYPES or shape is None:
        raise ValueError(f"the kernel takes a float32 or bfloat16 y, contiguous (or "
                         f"channels-last with only a bias), got {y.dtype} strides {y.stride()}")
    n, c, h, w = shape
    small = {"bias": (bias, (c,)), "demod": (demod, (n, c)),
             "noise_weight": (noise_weight, (1,))}
    for name, (t, want) in small.items():
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != want
                              or not t.is_contiguous() or t.device != y.device):
            raise ValueError(f"{name}: expected a contiguous float32 {want} on {y.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    film_bs, film_ps, film_b = 0, 1, None
    if film is not None:
        film_ps = film.stride(3) if w > 1 else film.stride(2) if h > 1 else 1
        if (film.dtype != y.dtype or tuple(film.shape) != (n, 2, h, w) or film.device != y.device
                or film_ps < 1 or (w > 1 and h > 1 and film.stride(2) != w * film_ps)):
            raise ValueError(f"film: expected {y.dtype} {(n, 2, h, w)} on {y.device} with "
                             f"dense planes, got {film.dtype} {tuple(film.shape)} strides "
                             f"{film.stride()}")
        film_bs = film.stride(0) if n > 1 else h * w * film_ps
        film_b = film.data_ptr() + film.stride(1) * film.element_size()
    nn_, nh, nw = 0, 0, 0
    if noise is not None:
        nn_, _, nh, nw = noise.shape
        if (noise_weight is None or noise.dtype != torch.float32 or not noise.is_contiguous()
                or noise.device != y.device or noise.shape[1] != 1 or nn_ not in (1, n)
                or nh not in (1, h) or nw not in (1, w)):
            raise ValueError(f"noise: expected a contiguous float32 [{n} or 1, 1, "
                             f"{h} or 1, {w} or 1] on {y.device} and a noise_weight, got "
                             f"{noise.dtype} {tuple(noise.shape)} on {noise.device}")
    flags = ((_DEMOD if demod is not None else 0) | (_FILM if film is not None else 0)
             | (_BIAS if bias is not None else 0))
    out = torch.empty_like(y)

    def ptr(t):
        return None if t is None else t.data_ptr()

    return out, (ptr(y), ptr(out), ptr(demod), ptr(film), film_b, ptr(noise), ptr(noise_weight),
                 ptr(bias), n, c, h, w, film_bs, film_ps, nn_, nh, nw, flags,
                 _DTYPE_CODES[y.dtype], negative_slope, _gain(scale, y.dtype))


def fused_bias_act_cuda(y, bias=None, demod=None, film=None, noise=None, noise_weight=None,
                        negative_slope: float = 0.2, scale: float = SQRT2, dim: int = 1):
    """``fused_bias_act``'s kernel on the current stream, counted in
    ``fused_bias_act.launches``: float32 inside, the result rounded once to
    ``y``'s dtype, the gain ``scale`` rounded to that dtype as the plain
    chain rounds it. For a caller that has applied ``takes_kernel`` itself;
    raises on what the kernel does not take, and when the launch is
    refused."""
    from stylerenderer_tpu_torch.ops._build import library

    if y.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {y.device}")
    pre = demod is not None or film is not None or noise is not None
    if _layout(y, dim, pre) is None:
        y = y.contiguous()
    if noise is not None:  # widening to float32 is exact for the narrower types
        noise = noise.to(y.device, torch.float32).contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out, args = _kernel_args(y, bias, demod, film, noise, noise_weight, negative_slope, scale,
                             dim)
    lib = library("fused_act")
    rc = lib.sr_fused_bias_act(*args, torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_bias_act launch failed: " + lib.sr_error_string(rc).decode())
    fused_bias_act.launches += 1
    return out


def fused_bias_act_host(y, bias=None, demod=None, film=None, noise=None, noise_weight=None,
                        negative_slope: float = 0.2, scale: float = SQRT2, dim: int = 1):
    """The kernel's math and schedule compiled for the host (g++), on CPU
    tensors: ``fused_bias_act``'s result as the card computes it."""
    from stylerenderer_tpu_torch.ops._build import library

    if y.device.type != "cpu":
        raise ValueError(f"the host build takes CPU tensors, got {y.device}")
    out, args = _kernel_args(y, bias, demod, film, noise, noise_weight, negative_slope, scale,
                             dim)
    if library("fused_act_host").sr_fused_bias_act_host(*args) != 0:
        raise ValueError("fused_bias_act_host: arguments the kernel does not take")
    return out


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2, scale: float = SQRT2,
                     dim: int = 1) -> torch.Tensor:
    """``leaky_relu(x + bias, negative_slope) * scale``, ``bias`` ``[C]``
    broadcast along ``dim``: ``fused_bias_act`` without the terms ahead of
    the bias."""
    return fused_bias_act(x, bias, negative_slope=negative_slope, scale=scale, dim=dim)


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU followed by a sqrt(2) gain."""
    return fused_leaky_relu(x, None, negative_slope)


class FusedLeakyReLU(nn.Module):
    """Learned-bias ``fused_leaky_relu`` (state-dict name ``bias``)."""

    def __init__(self, channel: int, negative_slope: float = 0.2,
                 scale: float = SQRT2):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))
        self.negative_slope = negative_slope
        self.scale = scale

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
