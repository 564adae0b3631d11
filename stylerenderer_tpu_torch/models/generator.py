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
so a reference ``g_ema`` loads into it with ``strict=True``. With
``n_stylemap != 3`` the GAR adds ``norm1_pre`` and ``norm_to_style_pre.{i}``
(the JAX package's names).

``remat=True`` (both generators) runs each styled conv under
``torch.utils.checkpoint`` (non-reentrant, so ``torch.autograd.grad`` and
the path-length step's double backward pass through it): its activations
are recomputed in the backward instead of kept, the memory knob of the
1024 px model, as ``nn.remat`` is in JAX. Fresh noise is drawn before each
checkpointed conv, in the order and shapes the plain run draws it, because
the recompute restores only the global RNG states, not a caller's
``torch.Generator``: a generator gives the same images with ``remat`` on
and off.

``GeneratorWithMap`` takes a ``device_mesh`` (``parallel/mesh.py::
make_mesh_2d``; the name ``mesh`` is the face mesh's): on one that splits
rows over ``'space'``, the mapping network and the styles are replicated,
the normal pyramid is rendered band by band (``rasterize_pyramid_fused``
with the mesh: the multi-level kernel on the band's tiles) and every
layer runs on the rank's band of rows inside ``parallel/spatial.py::
sharded``, so the image is the rank's band. The gradients in the styles
and the mesh's vertices and normals are summed over ``'space'`` where they
leave (whole on every rank); the parameters' are the band's share, which
``Mesh.average_gradients`` sums.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.nn.layers import (
    ConstantInput,
    ConvLayer,
    EqualLinear,
    ModulatedConv2d,
    NoiseInjection,
    PixelNorm,
    ResBlock,
    Upsample,
    reset_parameters,
)
from stylerenderer_tpu_torch.ops import fused_act
from stylerenderer_tpu_torch.ops.fused_act import FusedLeakyReLU
from stylerenderer_tpu_torch.ops.rasterize import (
    rasterize,
    rasterize_pyramid,
    rasterize_pyramid_fused,
)
from stylerenderer_tpu_torch.ops.resize import resize_linear
from stylerenderer_tpu_torch.parallel import spatial
from stylerenderer_tpu_torch.utils.logging import SYNTHESIS_SPANS, trace_ctx


def channel_table(channel_multiplier: int = 2) -> dict[int, int]:
    """StyleGAN2 config-f channel schedule."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
        256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


class StyledConv(nn.Module):
    """Modulated conv, noise and the fused bias-lrelu.

    Where ``fused_act.takes_kernel`` holds for the call (on a card, autograd
    recording nothing, no ``sharded`` mesh active) and the conv computes in
    a type the kernel takes, everything after the conv (demodulation, FiLM,
    noise, bias, leaky ReLU, gain) is one ``fused_bias_act_cuda`` launch on
    the undemodulated conv output; otherwise the layers run one op a
    term. The rule is applied once, here: the launch raises rather than
    fall back."""

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
        if self._fused(x, style, noise):
            return self._epilogue(x, style, None, noise, generator)
        return self.activate(self.noise(self.conv(x, style), noise, generator))

    def _fused(self, x, *inputs) -> bool:
        return (self.conv.dtype in fused_act.KERNEL_DTYPES
                and fused_act.takes_kernel(x, *inputs, *self.parameters()))

    def _epilogue(self, x, style, film, noise, generator):
        y, demod = self.conv.undemodulated(x, style)
        return fused_act.fused_bias_act_cuda(
            y, self.activate.bias, demod, film, self.noise.noise_map(y, noise, generator),
            self.noise.weight, self.activate.negative_slope, self.activate.scale)


class StyledMapConv(StyledConv):
    """``StyledConv`` with FiLM from the normal map
    (``x * map[:, 0:1] + map[:, 1:2]``) between the conv and the noise."""

    def forward(self, x, style, stylemap, noise=None, generator=None):
        if self._fused(x, style, stylemap, noise):
            return self._epilogue(x, style, stylemap, noise, generator)
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

    def _styled(self, i: int, conv, x, *args, noise=None, generator=None):
        """Styled conv ``conv`` (noise layer ``i``) on ``x``; under ``remat``
        checkpointed, with its noise drawn first when none is given."""
        if not self.remat:
            return conv(x, *args, noise, generator)
        if noise is None:
            r = _noise_res(i)
            noise = torch.randn(x.shape[0], 1, r, r, generator=generator,
                                device=generator.device if generator else x.device)
        # the recompute runs in the backward, outside the caller's sharded()
        mesh = spatial.active()
        fn = conv if mesh is None else functools.partial(_in_band, mesh, conv)
        # the conv draws nothing itself now, so no RNG state to restore
        return checkpoint(fn, x, *args, noise, use_reentrant=False,
                          preserve_rng_state=False)

    def _latent_and_noise(self, styles, input_is_latent, noise, randomize_noise,
                          inject_index, truncation, truncation_latent):
        """Per-layer latents ``[B, n_latent, D]`` and the noise list
        (``randomize_noise=False`` with no ``noise``: the buffers)."""
        with trace_ctx("gar.mapping"):
            if not isinstance(styles, (list, tuple)):
                styles = [styles]
            if not input_is_latent:
                styles = [self.style(s) for s in styles]
            if noise is None and not randomize_noise:
                noise = [getattr(self.noises, f"noise_{i}") for i in range(self.num_layers)]
            latent = _mix_styles(styles, self.n_latent, inject_index, truncation,
                                 truncation_latent)
            return latent, noise


def _in_band(mesh, conv, *args):
    with spatial.sharded(mesh):
        return conv(*args)


class Generator(_StyleGenerator):
    """The unconditioned StyleGAN2 generator: constant 4x4 input, two styled
    convs and a ToRGB per resolution, per-layer noise. Parameters are drawn
    from ``seed`` and moved to ``device`` (``"cuda"`` unless asked
    otherwise); ``remat`` checkpoints the styled convs."""

    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, blur_kernel=(1, 3, 3, 1),
                 lr_mlp: float = 0.01, dtype=torch.float32, remat: bool = False,
                 seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.size, self.style_dim, self.dtype, self.remat = size, style_dim, dtype, remat
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
        out = self._styled(0, self.conv1, out, latent[:, 0], noise=noise[0],
                           generator=generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for level in range(len(self.to_rgbs)):
            out = self._styled(1 + 2 * level, self.convs[2 * level], out, latent[:, i],
                               noise=noise[1 + 2 * level], generator=generator)
            out = self._styled(2 + 2 * level, self.convs[2 * level + 1], out, latent[:, i + 1],
                               noise=noise[2 + 2 * level], generator=generator)
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
    shrinks that map level by level with the antialiased linear resize.
    ``n_stylemap``: the channels of the normal-map features; other than 3,
    a ``ConvLayer`` from the 3 normal channels (``norm1_pre``,
    ``norm_to_style_pre.{i}``) feeds each ResBlock. ``fused_pyramid``
    interpolates the normals inside the multi-level kernel; without it the
    values come from the gather interpolation over the winners of the
    multi-level kernel (``"each"``) or of ``rasterize`` (``"downsample"``).
    ``rasterize_method``
    is the rasterizer's ``method``; ``remat`` checkpoints the styled convs.
    Parameters are drawn from ``seed`` and moved to ``device`` (``"cuda"``
    unless asked otherwise).
    """

    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 n_stylemap: int = 3, channel_multiplier: int = 2, blur_kernel=(1, 3, 3, 1),
                 lr_mlp: float = 0.01, dtype=torch.float32,
                 pyramid_mode: str = "each", rasterize_method: str = "auto",
                 fused_pyramid: bool = True, remat: bool = False, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if pyramid_mode not in ("each", "downsample"):
            raise ValueError(f"pyramid_mode {pyramid_mode!r}: 'each' or 'downsample'")
        device = resolve_device(device)
        self.size, self.style_dim, self.dtype, self.remat = size, style_dim, dtype, remat
        self.n_stylemap = n_stylemap
        self.pyramid_mode, self.rasterize_method = pyramid_mode, rasterize_method
        self.fused_pyramid = fused_pyramid
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        ch = channel_table(channel_multiplier)

        self.style = MappingNetwork(style_dim, n_mlp, lr_mlp)
        self.input = ConstantInput(ch[4])
        if n_stylemap != 3:
            self.norm1_pre = ConvLayer(3, n_stylemap, 3, dtype=dtype)
        self.norm1 = ResBlock(n_stylemap, 2, downsample=False, dtype=dtype)
        self.conv1 = StyledMapConv(ch[4], ch[4], 3, style_dim, blur_kernel=blur_kernel,
                                   dtype=dtype)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False, dtype=dtype)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.norm_to_style = nn.ModuleList()
        if n_stylemap != 3:
            self.norm_to_style_pre = nn.ModuleList()
        in_channel = ch[4]
        for i in range(3, self.log_size + 1):
            out_channel = ch[2 ** i]
            self.convs.append(StyledMapConv(in_channel, out_channel, 3, style_dim,
                                            upsample=True, blur_kernel=blur_kernel,
                                            dtype=dtype))
            self.convs.append(StyledMapConv(out_channel, out_channel, 3, style_dim,
                                            blur_kernel=blur_kernel, dtype=dtype))
            if n_stylemap != 3:
                self.norm_to_style_pre.append(ConvLayer(3, n_stylemap, 3, dtype=dtype))
            self.norm_to_style.append(ResBlock(n_stylemap, 4, downsample=False, dtype=dtype))
            self.to_rgbs.append(ToRGB(out_channel, style_dim, dtype=dtype))
            in_channel = out_channel
        self._register_noise()
        reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def normal_pyramid(self, mesh, device_mesh=None):
        """Rasterized normal maps at 4, 8, ..., size, ``[B, s, s, 3]`` each
        (on a ``device_mesh`` that splits rows over ``'space'``, the rank's
        band of each, ``[B, s / n_space, s, 3]``). Only the fused ``each``
        pyramid renders by band; the others render every level whole on
        each space rank and cut the band, as GSPMD does with the JAX
        package's Pallas calls."""
        with trace_ctx("gar.pyramid"):
            return self._normal_pyramid(mesh, device_mesh)

    def _normal_pyramid(self, mesh, device_mesh):
        vert, norm, tri = mesh
        sizes = [4] + [2 ** i for i in range(3, self.log_size + 1)]
        method = self.rasterize_method
        if self.pyramid_mode == "each" and self.fused_pyramid:
            return rasterize_pyramid_fused(vert, norm, tri, sizes, method=method,
                                           mesh=device_mesh)
        banded = device_mesh is not None and device_mesh.n_space > 1
        if banded:
            vert, norm = spatial.enter_band(vert, device_mesh), spatial.enter_band(norm, device_mesh)
        if self.pyramid_mode == "each":
            maps = rasterize_pyramid(vert, norm, tri, sizes, method=method)
        else:
            if self.fused_pyramid:
                top = rasterize_pyramid_fused(vert, norm, tri, [self.size], method=method)[0]
            else:
                top = rasterize(vert, norm, tri, self.size, self.size, method=method)
            maps = [top]
            for s in reversed(sizes[:-1]):
                maps.append(resize_linear(maps[-1], s, s))
            maps = maps[::-1]
        if banded:
            maps = [m[:, spatial.band_rows(device_mesh, m.shape[1])] for m in maps]
        return maps

    def synthesize(self, latent, norm_maps, noise=None,
                   generator: torch.Generator | None = None, device_mesh=None):
        """Image ``[B, 3, size, size]`` from per-layer latents
        ``[B, n_latent, D]`` and a normal-map pyramid (smallest first, in the
        rasterizer's ``[B, s, s, C]`` layout). ``noise``: a list of
        ``[B or 1, 1, res, res]`` maps (``None`` entries draw fresh noise).
        On a ``device_mesh`` that splits rows over ``'space'``, the maps are
        the rank's bands, the noise maps whole, and the image is the rank's
        band."""
        with trace_ctx("gar.synthesis"), spatial.sharded(device_mesh):
            return self._synthesize(latent, norm_maps, noise, generator)

    def _synthesize(self, latent, norm_maps, noise, generator):
        if noise is None:
            noise = [None] * self.num_layers
        norm_maps = [m.permute(0, 3, 1, 2).to(self.dtype) for m in norm_maps]
        with trace_ctx(SYNTHESIS_SPANS[4]):
            out = self.input(latent.shape[0]).to(self.dtype)
            nm = norm_maps[0]
            if self.n_stylemap != 3:
                nm = self.norm1_pre(nm)
            out = self._styled(0, self.conv1, out, latent[:, 0], self.norm1(nm),
                               noise=noise[0], generator=generator)
            skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for level in range(len(self.to_rgbs)):
            with trace_ctx(SYNTHESIS_SPANS[8 << level]):
                nm = norm_maps[level + 1]
                if self.n_stylemap != 3:
                    nm = self.norm_to_style_pre[level](nm)
                maps = self.norm_to_style[level](nm)
                out = self._styled(1 + 2 * level, self.convs[2 * level], out, latent[:, i],
                                   maps[:, :2], noise=noise[1 + 2 * level], generator=generator)
                out = self._styled(2 + 2 * level, self.convs[2 * level + 1], out,
                                   latent[:, i + 1], maps[:, 2:], noise=noise[2 + 2 * level],
                                   generator=generator)
                skip = self.to_rgbs[level](out, latent[:, i + 2], skip)
            i += 2
        return skip

    def forward(self, styles, mesh, return_normals: bool = False,
                return_latents: bool = False, inject_index=None,
                truncation: float | None = None, truncation_latent=None,
                input_is_latent: bool = False, noise=None,
                randomize_noise: bool = True,
                generator: torch.Generator | None = None, device_mesh=None):
        """-> (image ``[B, 3, size, size]``, latents or None, normal maps or
        None). ``randomize_noise=False`` with no ``noise`` uses the
        ``noises.noise_{i}`` buffers. With a ``device_mesh`` (the module's
        docstring), the image and normal maps are the rank's bands."""
        if device_mesh is not None and device_mesh.n_space > 1:
            styles = [spatial.enter_band(s, device_mesh)
                      for s in (styles if isinstance(styles, (list, tuple)) else [styles])]
        latent, noise = self._latent_and_noise(styles, input_is_latent, noise,
                                               randomize_noise, inject_index, truncation,
                                               truncation_latent)
        # without a mesh, the one-argument call that overrides of
        # normal_pyramid (and wrappers that record it) take
        norm_maps = (self.normal_pyramid(mesh) if device_mesh is None
                     else self.normal_pyramid(mesh, device_mesh))
        image = self.synthesize(latent, norm_maps, noise, generator, device_mesh)
        return (image, latent if return_latents else None,
                norm_maps if return_normals else None)
