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

Inside ``parallel/spatial.py::sharded(mesh)`` every spatial layer takes
this rank's band of rows of a map split over ``'space'`` and gives its band
of the output rows (``spatial.band_ops``: a halo as deep as the layer's
reach in input rows, its H padding replaced by the plan's): the 3x3 convs,
the blurs, the FIR up- and downsamples, the three forms of the modulated
conv (the transposed conv and its blur share one exchange, as do a
downsampling blur and its stride-2 conv, since the blur's own output
rows do not split into equal bands), ``NoiseInjection`` (its band of the
whole map's noise) and ``ConstantInput`` (its band of the 4x4 map).
Elementwise layers need nothing. Outside a ``sharded``, every layer is as
before.
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
from stylerenderer_tpu_torch.ops.upfirdn2d import (
    downsample2d,
    make_kernel,
    upfirdn2d,
    upfirdn2d_band,
)
from stylerenderer_tpu_torch.parallel import spatial


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
        mesh, k = spatial.active(), self.weight.shape[2]
        if mesh is not None and (k > 1 or self.stride > 1):
            h_out = (x.shape[2] * mesh.n_space + 2 * self.padding - k) // self.stride + 1
            x, ((q0, q1),) = spatial.band_ops(x, [(1, self.stride, k, self.padding)], h_out,
                                              mesh)
            return self.conv(spatial.pad_rows(x, q0, q1), (0, self.padding))
        return self.conv(x, self.padding)

    def conv(self, x, padding):
        """The scaled conv and its bias, with ``padding`` (an int, or
        ``(H, W)``)."""
        y = F.conv2d(x.to(self.dtype), (self.weight * self.scale).to(self.dtype),
                     stride=self.stride, padding=padding)
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
        mesh = spatial.active()
        if mesh is not None:
            return upfirdn2d_band(x, self.kernel, mesh, pad=self.pad)
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
        mesh = spatial.active()
        if mesh is not None:
            return upfirdn2d_band(x, self.kernel, mesh, up=self.factor, pad=self.pad)
        return upfirdn2d(x, self.kernel, up=self.factor, down=1, pad=self.pad)


class Downsample(nn.Module):
    """FIR 2x downsample; the kernel is a ``kernel`` buffer."""

    def __init__(self, kernel=(1, 3, 3, 1), factor: int = 2):
        super().__init__()
        self.factor = factor
        self.register_buffer("kernel", make_kernel(list(kernel)))

    def forward(self, x):
        mesh = spatial.active()
        if mesh is not None:
            p = self.kernel.shape[0] - self.factor
            return upfirdn2d_band(x, self.kernel, mesh, down=self.factor,
                                  pad=((p + 1) // 2, p // 2))
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
        xs, ws, demod = self._modulate(x, style)
        mesh = spatial.active()
        if mesh is not None:
            y = self._band(xs, ws, mesh, demod)
            return y if self.upsample else self._demodulate(y, demod)
        if self.upsample:
            y = F.conv_transpose2d(xs.to(self.dtype), ws.transpose(0, 1), stride=2)
            return self.blur(self._demodulate(y, demod))
        return self._demodulate(self._conv(xs, ws), demod)

    def undemodulated(self, x, style):
        """-> (y, demod): the conv's output before demodulation (outside a
        ``sharded`` mesh) and the factor ``[B, out]`` float32 (``None``
        without demodulation), for an epilogue that applies it. The
        upsampling conv's blur is applied to ``y`` already: the blur is
        linear within each ``(b, c)`` plane and ``demod`` is constant on it,
        so demodulating after the blur is the same function (``forward``
        demodulates first; the two round differently)."""
        xs, ws, demod = self._modulate(x, style)
        if self.upsample:
            return self.blur(F.conv_transpose2d(xs.to(self.dtype), ws.transpose(0, 1),
                                                stride=2)), demod
        return self._conv(xs, ws), demod

    def _modulate(self, x, style):
        """-> (``x`` scaled by the style, the scaled weight in the compute
        type, the demodulation factor or ``None``)."""
        w = self.weight[0] * self.scale  # [out, in, k, k]
        s = self.modulation(style)  # [B, in]
        xs = x * s[:, :, None, None].to(x.dtype)
        demod = None
        if self.demodulate:
            w2 = torch.sum(w * w, dim=(2, 3))  # [out, in]
            demod = torch.rsqrt((s * s) @ w2.t() + self.eps)  # [B, out]
        return xs, w.to(self.dtype), demod

    def _conv(self, xs, ws):
        """The plain or downsampling conv of ``xs``, not demodulated."""
        if self.downsample:
            return F.conv2d(self.blur(xs).to(self.dtype), ws, stride=2)
        return F.conv2d(xs.to(self.dtype), ws, padding=self.kernel_size // 2)

    def _demodulate(self, y, demod):
        if self.demodulate:
            y = y * demod[:, :, None, None].to(y.dtype)
        return y

    def _band(self, xs, ws, mesh, demod):
        """The conv of this rank's band ``xs`` (scaled by the style) under
        ``'space'``: upsampling, the transposed conv (``(2, 1, k, k - 1)``
        along H, whose own output pads are ``(k - 1, k - 2)``) cropped to
        the plan, demodulated, then the blur; downsampling, the blur then
        the stride-2 conv; else the conv with its halo. Demodulation of the
        latter two is the caller's."""
        k, h = self.kernel_size, xs.shape[2] * mesh.n_space
        if self.upsample:
            kb, (b0, b1) = self.blur.kernel.shape[0], self.blur.pad
            ops = [(2, 1, k, k - 1), (1, 1, kb, b0)]
            x, ((q0, q1), (r0, r1)) = spatial.band_ops(xs, ops, 2 * h + k - 2 + b0 + b1 - kb + 1,
                                                       mesh)
            y = F.conv_transpose2d(x.to(self.dtype), ws.transpose(0, 1), stride=2)
            y = self._demodulate(spatial.pad_rows(y, q0 - (k - 1), q1 - (k - 2)), demod)
            return upfirdn2d(y, self.blur.kernel, pad=(b0, b1, r0, r1))
        if self.downsample:
            return F.conv2d(_blur_for_stride2(xs, self.blur, k, mesh).to(self.dtype), ws, stride=2)
        if k == 1:
            return F.conv2d(xs.to(self.dtype), ws)
        x, ((q0, q1),) = spatial.band_ops(xs, [(1, 1, k, k // 2)], h, mesh)
        return F.conv2d(spatial.pad_rows(x, q0, q1).to(self.dtype), ws, padding=(0, k // 2))


def _blur_for_stride2(x, blur, k: int, mesh):
    """Under ``'space'``: this rank's band ``x`` blurred by ``blur`` (its
    own pads), with the H rows that a ``k``-tap stride-2 conv without H
    padding then reads for this rank's band of its output. The blur's own
    output (H + 1 rows) does not split into equal bands, so the two are
    planned as one chain and exchanged once."""
    kb, (b0, b1) = blur.kernel.shape[0], blur.pad
    h = x.shape[2] * mesh.n_space
    x, ((r0, r1), (q0, q1)) = spatial.band_ops(
        x, [(1, 1, kb, b0), (1, 2, k, 0)], (h + b0 + b1 - kb + 1 - k) // 2 + 1, mesh)
    return spatial.pad_rows(upfirdn2d(x, blur.kernel, pad=(b0, b1, r0, r1)), q0, q1)


class NoiseInjection(nn.Module):
    """``x + weight * noise``; fresh N(0, 1) noise per pixel when none is given."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.zero_()

    def forward(self, x, noise=None, generator: torch.Generator | None = None):
        return x + self.weight.to(x.dtype) * self.noise_map(x, noise, generator).to(
            x.device, x.dtype)

    def noise_map(self, x, noise=None, generator: torch.Generator | None = None):
        """The map added to ``x``: ``noise``, or one drawn here. Under
        ``'space'``, ``x`` is a band and ``noise`` (given, or drawn here) the
        whole map's, of which the band's rows are taken: ranks that seed
        ``generator`` alike draw one map."""
        mesh = spatial.active()
        if noise is None:
            b, _, h, w = x.shape
            h = h if mesh is None else h * mesh.n_space
            noise = torch.randn(b, 1, h, w, generator=generator,
                                device=generator.device if generator else x.device)
        if mesh is not None:
            noise = noise[:, :, spatial.band_rows(mesh, noise.shape[2])]
        return noise


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
        """The map for ``batch`` samples (under ``'space'``, its band)."""
        mesh = spatial.active()
        out = self.input.repeat(batch, 1, 1, 1)
        return out if mesh is None else out[:, :, spatial.band_rows(mesh, out.shape[2])]


class _ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return scaled_leaky_relu(x)


class ConvLayer(nn.Sequential):
    """``[Blur if downsample] EqualConv2d [FusedLeakyReLU]`` as a Sequential,
    so the state-dict names are the reference's ``{i}.weight``/``{i}.bias``.

    ``activate``: ``True`` or ``"lrelu"`` adds the activation, ``False`` (or
    another string) leaves it out; a string holding ``"sp"`` builds the
    spectral-norm conv ``SpectralEqualConv2d`` with no activation, in
    float32 whatever ``dtype`` (as the JAX package's ``ConvLayer``).

    Downsampling under ``'space'``, the blur and the stride-2 conv run on
    one halo (``forward``)."""

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
            self.downsample = downsample
            return
        if isinstance(activate, str):
            activate = activate == "lrelu"
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size, stride,
                                  padding, bias=bias, dtype=dtype))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias else _ScaledLeakyReLU())
        super().__init__(*layers)
        self.downsample = downsample

    def forward(self, x):
        mesh = spatial.active()
        if mesh is None or not self.downsample:
            return super().forward(x)
        blur, conv, *rest = self
        if not isinstance(conv, EqualConv2d):
            raise NotImplementedError("a spectral-norm downsampling ConvLayer under 'space'")
        y = conv.conv(_blur_for_stride2(x, blur, conv.weight.shape[2], mesh), (0, 0))
        for m in rest:
            y = m(y)
        return y


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


def minibatch_stddev(x, group_size: int = 4, num_features: int = 1, mesh=None):
    """The minibatch standard-deviation channel: samples are grouped as
    ``reshape(g, b // g, ...)`` with ``g = min(b, group_size)``; per group
    member, the biased std over the group (``+1e-8`` inside the sqrt),
    averaged over (C/f, H, W), is appended as ``f`` channels.

    With a ``mesh`` (``parallel/mesh.py``) that has a group, ``x`` is a
    rank's rows of the global batch: the groups are taken over the global
    batch, gathered with gradient over ``'data'`` (``Mesh.gather_rows``),
    and the rank's rows of the channel are appended. Without a group
    nothing is cut, since a slice in the graph can change the order of the
    backward's sums. On a mesh that splits rows over ``'space'``, ``x`` is
    also a band: the per-pixel std stays local, its mean over (C/f, H, W)
    is the band's sum, summed over ``'space'`` (``spatial.sum_space``) and
    divided by the whole map's count, and re-enters the band through
    ``spatial.enter_band``."""
    rows = None
    if mesh is not None and mesh.group is not None:
        local, x = x, mesh.gather_rows(x)
        rows = mesh.rows(x.shape[0])
    b, c, h, w = x.shape
    g = min(b, group_size)
    f = num_features
    y = x.reshape(g, b // g, f, c // f, h, w)
    std = torch.sqrt(torch.var(y, dim=0, unbiased=False) + 1e-8)
    if mesh is not None and mesh.n_space > 1:
        std = spatial.sum_space(torch.sum(std, dim=(2, 3, 4)), mesh)
        std = spatial.enter_band(std * (1.0 / (c // f * h * mesh.n_space * w)), mesh)
    else:
        std = torch.mean(std, dim=(2, 3, 4))  # [b // g, f]
    std = std[None, :, :, None, None].expand(g, b // g, f, h, w).reshape(b, f, h, w)
    if rows is not None:
        x, std = local, std[rows]
    return torch.cat([x, std.to(x.dtype)], 1)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` anew from ``generator``, module by
    module in registration order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
