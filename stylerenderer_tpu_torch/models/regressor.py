"""The Regressor, the image-to-latent encoder of Render Inverting
(counterpart of ``stylerenderer_tpu/models/regressor.py``), NCHW.

Per scale: a 3x3 conv of the features beside a 1x1 conv of the RGB image
resized to that scale, concatenated (features first) and shrunk by a
downsampling conv; the spatial mean and the unbiased variance (ddof=1) of
every scale's features, then the 4x4 features flattened, feed ``n_mlp``
equalized linears (fused LeakyReLU, ``lr_mul=lr_mlp``) and a PixelNorm.
The RGB image is resized with the JAX package's antialiased linear resize
(``ops/resize.py::resize_linear``).

The reference's Regressor (``model.py:337-387``) is dead code with two bugs
and no published state dict, so the modules are named after the JAX
package's: ``conv1``, ``conv{idx}_a``, ``from_rgb{idx}``, ``conv{idx}_b``,
``fc{i}`` (``ConvLayer`` Sequentials, ``EqualLinear``). The 4x4 features
are flattened in (C, H, W) order, the JAX model's in (H, W, C):
``utils/weights.py::regressor_state_dict_from_jax`` permutes those columns
of ``fc0`` (the statistics' columns keep their order).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.models.generator import channel_table
from stylerenderer_tpu_torch.nn.layers import ConvLayer, EqualLinear, PixelNorm, reset_parameters
from stylerenderer_tpu_torch.ops.resize import resize_linear


def _stats(t: torch.Tensor):
    """Per-channel spatial mean and unbiased variance of ``[B, C, H, W]``."""
    return [torch.mean(t, dim=(2, 3)), torch.var(t, dim=(2, 3), unbiased=True)]


class Regressor(nn.Module):
    """``[B, 3, size, size]`` images -> ``[B, style_dim]`` pixel-normed
    latents. Parameters are drawn from ``seed`` and moved to ``device``
    (``"cuda"`` unless asked otherwise); ``dtype`` is the convs' compute
    type."""

    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, blur_kernel=(1, 3, 3, 1),
                 lr_mlp: float = 0.01, dtype=torch.float32, seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        ch = channel_table(channel_multiplier)
        self.size, self.style_dim, self.n_mlp, self.dtype = size, style_dim, n_mlp, dtype
        self.n_scales = int(math.log2(size)) - 2
        self.conv1 = ConvLayer(3, ch[size], 1, dtype=dtype)
        in_channel, n_stats = ch[size], 2 * ch[size]
        for idx, i in enumerate(range(int(math.log2(size)), 2, -1)):
            out_channel = ch[2 ** i]
            setattr(self, f"conv{idx}_a", ConvLayer(in_channel, out_channel // 2, 3, dtype=dtype))
            setattr(self, f"from_rgb{idx}", ConvLayer(3, out_channel // 2, 1, dtype=dtype))
            setattr(self, f"conv{idx}_b", ConvLayer(out_channel, out_channel, 3, downsample=True,
                                                    blur_kernel=blur_kernel, dtype=dtype))
            in_channel = out_channel
            n_stats += 2 * out_channel
        self.n_stats = n_stats
        in_dim = n_stats + in_channel * 4 * 4
        for i in range(n_mlp):
            setattr(self, f"fc{i}", EqualLinear(in_dim if i == 0 else style_dim, style_dim,
                                                lr_mul=lr_mlp, activation="fused_lrelu"))
        self.pixel_norm = PixelNorm()
        reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.fc0.weight.device

    def forward(self, rgb):
        rgb = rgb.to(self.dtype)
        out = self.conv1(rgb)
        latents = _stats(out)
        rgb_hw = rgb.permute(0, 2, 3, 1)  # the resize's layout
        for idx in range(self.n_scales):
            out = getattr(self, f"conv{idx}_a")(out)
            rgb_feat = getattr(self, f"from_rgb{idx}")(rgb_hw.permute(0, 3, 1, 2))
            out = getattr(self, f"conv{idx}_b")(torch.cat([out, rgb_feat], 1))
            rgb_hw = resize_linear(rgb_hw, out.shape[2], out.shape[3])
            latents += _stats(out)
        latents.append(out.reshape(out.shape[0], -1))
        w = torch.cat([t.float() for t in latents], -1)
        for i in range(self.n_mlp):
            w = getattr(self, f"fc{i}")(w)
        return self.pixel_norm(w)
