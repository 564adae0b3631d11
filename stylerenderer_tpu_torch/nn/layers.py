"""StyleGAN2 layers (counterpart of ``stylerenderer_tpu/nn/layers.py``).

NCHW, with the reference PyTorch model's state-dict names and shapes:
linear weights ``[out, in]``, convs OIHW, the modulated conv weight
``[1, out, in, kh, kw]``, FIR kernels as ``kernel`` buffers. Parameters stay
float32; ``dtype`` (float32 or bfloat16) is the compute type, as in the
JAX package. Equalized learning rate: weights are drawn N(0, 1) (/lr_mul)
and scaled by ``lr_mul / sqrt(fan_in)`` at run time.

``ModulatedConv2d`` uses the JAX package's activation-scaling form: scale
the inputs by the per-sample style, convolve with the shared weight, scale
the outputs by the demodulation factor. It is the same algebra as the
reference's per-sample weights with a grouped convolution.

``ConvLayer`` keeps the JAX package's layout: its conv carries a bias
(``.0.bias``) beside the activation's (``.1.bias``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from stylerenderer_tpu_torch.ops.fused_act import (
    FusedLeakyReLU,
    fused_leaky_relu,
    scaled_leaky_relu,
)
from stylerenderer_tpu_torch.nn.spectral import SpectralEqualConv2d
from stylerenderer_tpu_torch.ops.upfirdn2d import downsample2d, make_kernel, upfirdn2d


class PixelNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps)`` over the feature axis."""

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.eps)


class EqualLinear(nn.Module):
    """Linear with the run-time weight scale ``lr_mul / sqrt(in_dim)``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: str | None = None, dtype=torch.float32):
        super().__init__()
        if activation not in (None, "fused_lrelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        self.bias_init = bias_init
        self.lr_mul = lr_mul
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.activation = activation
        self.dtype = dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                              / self.lr_mul)
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def forward(self, x):
        y = F.linear(x.to(self.dtype), (self.weight * self.scale).to(self.dtype))
        b = self.bias * self.lr_mul if self.bias is not None else None
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, b, dim=-1)
        if b is not None:
            y = y + b.to(y.dtype)
        return y


class EqualConv2d(nn.Module):
    """Conv with the run-time weight scale ``1/sqrt(fan_in)``; OIHW weight."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channel, in_channel, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size * kernel_size)
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype), (self.weight * self.scale).to(self.dtype),
                     stride=self.stride, padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None, None]
        return y


class Blur(nn.Module):
    """FIR blur with explicit pads; the kernel is a ``kernel`` buffer."""

    def __init__(self, kernel=(1, 3, 3, 1), pad=(0, 0), upsample_factor: int = 1):
        super().__init__()
        k = make_kernel(list(kernel))
        if upsample_factor > 1:
            k = k * (upsample_factor ** 2)
        self.register_buffer("kernel", k)
        self.pad = tuple(pad)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    """FIR 2x upsample; the kernel is a ``kernel`` buffer."""

    def __init__(self, kernel=(1, 3, 3, 1), factor: int = 2):
        super().__init__()
        self.factor = factor
        k = make_kernel(list(kernel)) * (factor ** 2)
        self.register_buffer("kernel", k)
        p = k.shape[0] - factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, up=self.factor, down=1, pad=self.pad)


class Downsample(nn.Module):
    """FIR 2x downsample; the kernel is a ``kernel`` buffer."""

    def __init__(self, kernel=(1, 3, 3, 1), factor: int = 2):
        super().__init__()
        self.factor = factor
        self.register_buffer("kernel", make_kernel(list(kernel)))

    def forward(self, x):
        return downsample2d(x, self.kernel, self.factor)


class ModulatedConv2d(nn.Module):
    """The StyleGAN2 modulated convolution, activation-scaling form:
    ``y = demod * conv(x * style, scale * W)``."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True, upsample: bool = False,
                 downsample: bool = False, blur_kernel=(1, 3, 3, 1),
                 dtype=torch.float32, eps: float = 1e-8):
        super().__init__()
        k = kernel_size
        self.in_channel, self.out_channel, self.kernel_size = in_channel, out_channel, k
        self.demodulate, self.upsample, self.downsample = demodulate, upsample, downsample
        self.dtype, self.eps = dtype, eps
        self.scale = 1.0 / math.sqrt(in_channel * k * k)
        self.weight = nn.Parameter(torch.empty(1, out_channel, in_channel, k, k))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        factor = 2
        if upsample:
            p = (len(blur_kernel) - factor) - (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2 + factor - 1, p // 2 + 1),
                             upsample_factor=factor)
        elif downsample:
            p = (len(blur_kernel) - factor) + (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2, p // 2))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator))

    def forward(self, x, style):
        w = self.weight[0] * self.scale  # [out, in, k, k]
        s = self.modulation(style)  # [B, in]
        xs = x * s[:, :, None, None].to(x.dtype)
        if self.demodulate:
            w2 = torch.sum(w * w, dim=(2, 3))  # [out, in]
            demod = torch.rsqrt((s * s) @ w2.t() + self.eps)  # [B, out]
        ws = w.to(self.dtype)
        if self.upsample:
            y = F.conv_transpose2d(xs.to(self.dtype), ws.transpose(0, 1), stride=2)
            if self.demodulate:
                y = y * demod[:, :, None, None].to(y.dtype)
            return self.blur(y)
        if self.downsample:
            y = F.conv2d(self.blur(xs).to(self.dtype), ws, stride=2)
        else:
            y = F.conv2d(xs.to(self.dtype), ws, padding=self.kernel_size // 2)
        if self.demodulate:
            y = y * demod[:, :, None, None].to(y.dtype)
        return y


class NoiseInjection(nn.Module):
    """``x + weight * noise``; fresh N(0, 1) noise per pixel when none is given."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.zero_()

    def forward(self, x, noise=None, generator: torch.Generator | None = None):
        if noise is None:
            b, _, h, w = x.shape
            noise = torch.randn(b, 1, h, w, generator=generator,
                                device=generator.device if generator else x.device)
        return x + self.weight.to(x.dtype) * noise.to(x.device, x.dtype)


class ConstantInput(nn.Module):
    """Learned constant input map ``[1, C, size, size]``."""

    def __init__(self, channel: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channel, size, size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.input.copy_(torch.randn(self.input.shape, generator=generator))

    def forward(self, batch: int):
        return self.input.repeat(batch, 1, 1, 1)


class _ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return scaled_leaky_relu(x)


class ConvLayer(nn.Sequential):
    """``[Blur if downsample] EqualConv2d [FusedLeakyReLU]`` as a Sequential,
    so the state-dict names are the reference's ``{i}.weight``/``{i}.bias``.

    ``activate``: ``True`` or ``"lrelu"`` adds the activation, ``False`` (or
    another string) leaves it out; a string holding ``"sp"`` builds the
    spectral-norm conv ``SpectralEqualConv2d`` with no activation, in
    float32 whatever ``dtype`` (as the JAX package's ``ConvLayer``)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False, blur_kernel=(1, 3, 3, 1),
                 bias: bool = True, activate: bool | str = True, dtype=torch.float32):
        layers = []
        if downsample:
            factor = 2
            p = (len(blur_kernel) - factor) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        if isinstance(activate, str) and "sp" in activate.lower():
            layers.append(SpectralEqualConv2d(in_channel, out_channel, kernel_size, stride,
                                              padding, bias=bias))
            super().__init__(*layers)
            return
        if isinstance(activate, str):
            activate = activate == "lrelu"
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size, stride,
                                  padding, bias=bias, dtype=dtype))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias else _ScaledLeakyReLU())
        super().__init__(*layers)


class ResBlock(nn.Module):
    """conv3x3 + (down)conv3x3 with a 1x1 skip, summed and scaled by 1/sqrt(2)."""

    def __init__(self, in_channel: int, out_channel: int, blur_kernel=(1, 3, 3, 1),
                 downsample: bool = True, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3, dtype=dtype)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=downsample,
                               blur_kernel=blur_kernel, dtype=dtype)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=downsample,
                              blur_kernel=blur_kernel, bias=False, activate=False,
                              dtype=dtype)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2)


def minibatch_stddev(x, group_size: int = 4, num_features: int = 1):
    """The minibatch standard-deviation channel: samples are grouped as
    ``reshape(g, b // g, ...)`` with ``g = min(b, group_size)``; per group
    member, the biased std over the group (``+1e-8`` inside the sqrt),
    averaged over (C/f, H, W), is appended as ``f`` channels."""
    b, c, h, w = x.shape
    g = min(b, group_size)
    f = num_features
    y = x.reshape(g, b // g, f, c // f, h, w)
    std = torch.sqrt(torch.var(y, dim=0, unbiased=False) + 1e-8)
    std = torch.mean(std, dim=(2, 3, 4))  # [b // g, f]
    std = std[None, :, :, None, None].expand(g, b // g, f, h, w).reshape(b, f, h, w)
    return torch.cat([x, std.to(x.dtype)], 1)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` anew from ``generator``, module by
    module in registration order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
