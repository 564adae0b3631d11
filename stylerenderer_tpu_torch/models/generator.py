"""The StyleGAN2 generator and the GAR, a StyleGAN2 generator conditioned
on rasterized mesh normals (counterparts of ``Generator`` and
``GeneratorWithMap`` in ``stylerenderer_tpu/models/generator.py``).

In the GAR, at 4x4 and at every upsample step the mesh normals condition
the features at that resolution: rasterized per level (one multi-level
kernel pass renders the whole pyramid) or rasterized once and shrunk level
by level (``pyramid_mode="downsample"``); a per-resolution ResBlock turns
each normal map into (scale, shift) maps that modulate the styled
convolutions before noise and activation. NCHW, reference state-dict names
(``style.{i}``, ``input.input``, ``conv1``, ``convs.{i}``, ``to_rgb1``,
``to_rgbs.{i}``, ``norm1``, ``norm_to_style.{i}``, ``noises.noise_{i}``);
``Generator`` has the same names without ``norm1`` and ``norm_to_style``,
so a reference ``g_ema`` loads into it with ``strict=True``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.nn.layers import (
    ConstantInput,
    EqualLinear,
    ModulatedConv2d,
    NoiseInjection,
    PixelNorm,
    ResBlock,
    Upsample,
    reset_parameters,
)
from stylerenderer_tpu_torch.ops.fused_act import FusedLeakyReLU
from stylerenderer_tpu_torch.ops.rasterize import (
    rasterize,
    rasterize_pyramid,
    rasterize_pyramid_fused,
)
from stylerenderer_tpu_torch.ops.resize import resize_linear


def channel_table(channel_multiplier: int = 2) -> dict[int, int]:
    """StyleGAN2 config-f channel schedule."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
        256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


class StyledConv(nn.Module):
    """Modulated conv, noise and the fused bias-lrelu."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, upsample: bool = False, blur_kernel=(1, 3, 3, 1),
                 demodulate: bool = True, dtype=torch.float32):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size, style_dim,
                                    demodulate=demodulate, upsample=upsample,
                                    blur_kernel=blur_kernel, dtype=dtype)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)

    def forward(self, x, style, noise=None, generator=None):
        return self.activate(self.noise(self.conv(x, style), noise, generator))


class StyledMapConv(StyledConv):
    """``StyledConv`` with FiLM from the normal map
    (``x * map[:, 0:1] + map[:, 1:2]``) between the conv and the noise."""

    def forward(self, x, style, stylemap, noise=None, generator=None):
        x = self.conv(x, style)
        x = x * stylemap[:, 0:1] + stylemap[:, 1:2]
        x = self.noise(x, noise, generator)
        return self.activate(x)


class ToRGB(nn.Module):
    """1x1 modulated conv (no demodulation) + bias, plus the upsampled skip."""

    def __init__(self, in_channel: int, style_dim: int, upsample: bool = True,
                 blur_kernel=(1, 3, 3, 1), dtype=torch.float32):
        super().__init__()
        if upsample:
            self.upsample = Upsample(blur_kernel)
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False,
                                    dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, style, skip=None):
        out = self.conv(x, style)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class MappingNetwork(nn.Sequential):
    """PixelNorm + ``n_mlp`` equalized linears with the fused lrelu."""

    def __init__(self, style_dim: int, n_mlp: int, lr_mlp: float = 0.01):
        super().__init__(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu")
            for _ in range(n_mlp)])


def _noise_res(i: int) -> int:
    return 2 ** ((i + 5) // 2)


def make_noise(size: int, batch: int = 1, generator: torch.Generator | None = None,
               device=None) -> list[torch.Tensor]:
    """Per-layer noise ``[batch, 1, res, res]``: one 4x4 map, then two per
    resolution 8..size (drawn on ``generator``'s device, the CPU without
    one), moved to ``device``."""
    num_layers = (int(math.log2(size)) - 2) * 2 + 1
    gdev = generator.device if generator is not None else None
    return [torch.randn(batch, 1, _noise_res(i), _noise_res(i), generator=generator,
                        device=gdev).to(device) for i in range(num_layers)]


def stored_noise(num_layers: int) -> list[torch.Tensor]:
    """The port's fixed per-layer noise (``[1, 1, res, res]``, layer i drawn
    from seed i): the initial ``noises.noise_{i}`` buffers. Different draws
    from the JAX package's ``stored_noise``; pass noise explicitly to
    compare the two."""
    return [torch.randn(1, 1, _noise_res(i), _noise_res(i),
                        generator=torch.Generator().manual_seed(i))
            for i in range(num_layers)]


def _mix_styles(styles, n_latent: int, inject_index, truncation, truncation_latent):
    """Per-layer latents ``[B, n_latent, D]`` with optional truncation and
    two-style mixing (layers below ``inject_index`` take the first style)."""
    if truncation is not None and truncation_latent is not None:
        styles = [truncation_latent + truncation * (s - truncation_latent)
                  for s in styles]
    if len(styles) == 1:
        s = styles[0]
        if s.ndim == 3:
            return s
        return s[:, None, :].repeat(1, n_latent, 1)
    assert len(styles) == 2
    if inject_index is None:
        inject_index = n_latent // 2
    layer = torch.arange(n_latent, device=styles[0].device)[None, :, None]
    return torch.where(layer < inject_index, styles[0][:, None, :],
                       styles[1][:, None, :])


class _StyleGenerator(nn.Module):
    """What both generators share: the mapping network's latents, style
    mixing and truncation, and the ``noises.noise_{i}`` buffers."""

    def _register_noise(self):
        self.noises = nn.Module()
        for i, nz in enumerate(stored_noise(self.num_layers)):
            self.noises.register_buffer(f"noise_{i}", nz)

    @property
    def device(self) -> torch.device:
        return self.input.input.device

    def get_latent(self, z):
        return self.style(z)

    def mean_latent(self, n_latent: int, generator: torch.Generator | None = None):
        z = torch.randn(n_latent, self.style_dim, generator=generator).to(self.device)
        return self.style(z).mean(0, keepdim=True)

    def _latent_and_noise(self, styles, input_is_latent, noise, randomize_noise,
                          inject_index, truncation, truncation_latent):
        """Per-layer latents ``[B, n_latent, D]`` and the noise list
        (``randomize_noise=False`` with no ``noise``: the buffers)."""
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.style(s) for s in styles]
        if noise is None and not randomize_noise:
            noise = [getattr(self.noises, f"noise_{i}") for i in range(self.num_layers)]
        latent = _mix_styles(styles, self.n_latent, inject_index, truncation,
                             truncation_latent)
        return latent, noise


class Generator(_StyleGenerator):
    """The unconditioned StyleGAN2 generator: constant 4x4 input, two styled
    convs and a ToRGB per resolution, per-layer noise. Parameters are drawn
    from ``seed`` and moved to ``device`` (``"cuda"`` unless asked
    otherwise)."""

    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, blur_kernel=(1, 3, 3, 1),
                 lr_mlp: float = 0.01, dtype=torch.float32, seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.size, self.style_dim, self.dtype = size, style_dim, dtype
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        ch = channel_table(channel_multiplier)

        self.style = MappingNetwork(style_dim, n_mlp, lr_mlp)
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim, blur_kernel=blur_kernel,
                                dtype=dtype)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False, dtype=dtype)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channel = ch[4]
        for i in range(3, self.log_size + 1):
            out_channel = ch[2 ** i]
            self.convs.append(StyledConv(in_channel, out_channel, 3, style_dim,
                                         upsample=True, blur_kernel=blur_kernel, dtype=dtype))
            self.convs.append(StyledConv(out_channel, out_channel, 3, style_dim,
                                         blur_kernel=blur_kernel, dtype=dtype))
            self.to_rgbs.append(ToRGB(out_channel, style_dim, dtype=dtype))
            in_channel = out_channel
        self._register_noise()
        reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def synthesize(self, latent, noise=None, generator: torch.Generator | None = None):
        """Image ``[B, 3, size, size]`` from per-layer latents
        ``[B, n_latent, D]``; ``noise`` as in ``GeneratorWithMap.synthesize``."""
        if noise is None:
            noise = [None] * self.num_layers
        out = self.input(latent.shape[0]).to(self.dtype)
        out = self.conv1(out, latent[:, 0], noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for level in range(len(self.to_rgbs)):
            out = self.convs[2 * level](out, latent[:, i], noise[1 + 2 * level], generator)
            out = self.convs[2 * level + 1](out, latent[:, i + 1], noise[2 + 2 * level],
                                            generator)
            skip = self.to_rgbs[level](out, latent[:, i + 2], skip)
            i += 2
        return skip

    def forward(self, styles, return_latents: bool = False, inject_index=None,
                truncation: float | None = None, truncation_latent=None,
                input_is_latent: bool = False, noise=None, randomize_noise: bool = True,
                generator: torch.Generator | None = None):
        """-> (image ``[B, 3, size, size]``, latents or None).
        ``randomize_noise=False`` with no ``noise`` uses the
        ``noises.noise_{i}`` buffers."""
        latent, noise = self._latent_and_noise(styles, input_is_latent, noise,
                                               randomize_noise, inject_index, truncation,
                                               truncation_latent)
        image = self.synthesize(latent, noise, generator)
        return image, latent if return_latents else None


class GeneratorWithMap(_StyleGenerator):
    """The Generative Adversarial Renderer.

    ``mesh = (vert [B, nv, 3], norm [B, nv, 3], tri [nf, 3])``.
    ``pyramid_mode``: ``"each"`` rasterizes the normals at every level
    (reference-exact); ``"downsample"`` rasterizes once at ``size`` and
    shrinks that map level by level with the antialiased linear resize
    (``n_stylemap != 3`` is not ported). ``fused_pyramid`` interpolates the
    normals inside the multi-level kernel; without it the values come from
    the gather interpolation over the winners of the multi-level kernel
    (``"each"``) or of ``rasterize`` (``"downsample"``). ``rasterize_method``
    is the rasterizer's ``method``. Parameters are drawn from ``seed`` and
    moved to ``device`` (``"cuda"`` unless asked otherwise).
    """

    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, blur_kernel=(1, 3, 3, 1),
                 lr_mlp: float = 0.01, dtype=torch.float32,
                 pyramid_mode: str = "each", rasterize_method: str = "auto",
                 fused_pyramid: bool = True, seed: int = 0, device="cuda"):
        super().__init__()
        if pyramid_mode not in ("each", "downsample"):
            raise ValueError(f"pyramid_mode {pyramid_mode!r}: 'each' or 'downsample'")
        device = resolve_device(device)
        self.size, self.style_dim, self.dtype = size, style_dim, dtype
        self.pyramid_mode, self.rasterize_method = pyramid_mode, rasterize_method
        self.fused_pyramid = fused_pyramid
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        ch = channel_table(channel_multiplier)

        self.style = MappingNetwork(style_dim, n_mlp, lr_mlp)
        self.input = ConstantInput(ch[4])
        self.norm1 = ResBlock(3, 2, downsample=False, dtype=dtype)
        self.conv1 = StyledMapConv(ch[4], ch[4], 3, style_dim, blur_kernel=blur_kernel,
                                   dtype=dtype)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False, dtype=dtype)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.norm_to_style = nn.ModuleList()
        in_channel = ch[4]
        for i in range(3, self.log_size + 1):
            out_channel = ch[2 ** i]
            self.convs.append(StyledMapConv(in_channel, out_channel, 3, style_dim,
                                            upsample=True, blur_kernel=blur_kernel,
                                            dtype=dtype))
            self.convs.append(StyledMapConv(out_channel, out_channel, 3, style_dim,
                                            blur_kernel=blur_kernel, dtype=dtype))
            self.norm_to_style.append(ResBlock(3, 4, downsample=False, dtype=dtype))
            self.to_rgbs.append(ToRGB(out_channel, style_dim, dtype=dtype))
            in_channel = out_channel
        self._register_noise()
        reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def normal_pyramid(self, mesh):
        """Rasterized normal maps at 4, 8, ..., size, ``[B, s, s, 3]`` each."""
        vert, norm, tri = mesh
        sizes = [4] + [2 ** i for i in range(3, self.log_size + 1)]
        method = self.rasterize_method
        if self.pyramid_mode == "each":
            fn = rasterize_pyramid_fused if self.fused_pyramid else rasterize_pyramid
            return fn(vert, norm, tri, sizes, method=method)
        if self.fused_pyramid:
            top = rasterize_pyramid_fused(vert, norm, tri, [self.size], method=method)[0]
        else:
            top = rasterize(vert, norm, tri, self.size, self.size, method=method)
        maps = [top]
        for s in reversed(sizes[:-1]):
            maps.append(resize_linear(maps[-1], s, s))
        return maps[::-1]

    def synthesize(self, latent, norm_maps, noise=None,
                   generator: torch.Generator | None = None):
        """Image ``[B, 3, size, size]`` from per-layer latents
        ``[B, n_latent, D]`` and a normal-map pyramid (smallest first, in the
        rasterizer's ``[B, s, s, C]`` layout). ``noise``: a list of
        ``[B or 1, 1, res, res]`` maps (``None`` entries draw fresh noise)."""
        if noise is None:
            noise = [None] * self.num_layers
        norm_maps = [m.permute(0, 3, 1, 2).to(self.dtype) for m in norm_maps]
        out = self.input(latent.shape[0]).to(self.dtype)
        maps = self.norm1(norm_maps[0])
        out = self.conv1(out, latent[:, 0], maps, noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for level in range(len(self.to_rgbs)):
            maps = self.norm_to_style[level](norm_maps[level + 1])
            out = self.convs[2 * level](out, latent[:, i], maps[:, :2],
                                        noise[1 + 2 * level], generator)
            out = self.convs[2 * level + 1](out, latent[:, i + 1], maps[:, 2:],
                                            noise[2 + 2 * level], generator)
            skip = self.to_rgbs[level](out, latent[:, i + 2], skip)
            i += 2
        return skip

    def forward(self, styles, mesh, return_normals: bool = False,
                return_latents: bool = False, inject_index=None,
                truncation: float | None = None, truncation_latent=None,
                input_is_latent: bool = False, noise=None,
                randomize_noise: bool = True,
                generator: torch.Generator | None = None):
        """-> (image ``[B, 3, size, size]``, latents or None, normal maps or
        None). ``randomize_noise=False`` with no ``noise`` uses the
        ``noises.noise_{i}`` buffers."""
        latent, noise = self._latent_and_noise(styles, input_is_latent, noise,
                                               randomize_noise, inject_index, truncation,
                                               truncation_latent)
        norm_maps = self.normal_pyramid(mesh)
        image = self.synthesize(latent, norm_maps, noise, generator)
        return (image, latent if return_latents else None,
                norm_maps if return_normals else None)
