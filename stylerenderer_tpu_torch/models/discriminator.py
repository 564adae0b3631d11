"""The StyleGAN2 discriminator (counterpart of
``stylerenderer_tpu/models/discriminator.py``), NCHW.

State-dict names are the reference PyTorch model's, which
``stylerenderer_tpu/utils/torch_import.py::import_discriminator`` reads:
``convs.0`` (1x1 from-RGB), ``convs.{k}`` the downsampling ResBlocks,
``final_conv``, ``final_linear.0`` (fused lrelu) and ``final_linear.1``.
The 4x4 features are flattened in the reference's (C, H, W) order; the
JAX package flattens (H, W, C), so
``utils/weights.py::discriminator_state_dict_from_jax`` permutes the
columns of ``final_linear.0`` between the two.

On a mesh that splits rows over ``'space'`` (``parallel/mesh.py::
make_mesh_2d``), ``forward`` takes the rank's block ``[B / n_data, 3,
H / n_space, W]``: the convolutions, the stddev channel and ``final_conv``
run on the band, the 4x4 features are gathered over ``'space'``, and
``final_linear`` runs replicated, its parameters' gradients split over the
space ranks (``parallel/spatial.py``), so the logits are replicated over
``'space'``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.models.generator import channel_table
from stylerenderer_tpu_torch.nn.layers import (
    ConvLayer,
    EqualLinear,
    ResBlock,
    minibatch_stddev,
    reset_parameters,
)
from stylerenderer_tpu_torch.ops.fused_act import fused_leaky_relu
from stylerenderer_tpu_torch.parallel import spatial


class Discriminator(nn.Module):
    """``[B, 3, size, size]`` images -> ``[B, 1]`` logits. Parameters are
    drawn from ``seed`` and moved to ``device`` (``"cuda"`` unless asked
    otherwise); ``dtype`` is the compute type."""

    def __init__(self, size: int, channel_multiplier: int = 2, blur_kernel=(1, 3, 3, 1),
                 stddev_group: int = 4, stddev_feat: int = 1, dtype=torch.float32,
                 seed: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        ch = channel_table(channel_multiplier)
        log_size = int(math.log2(size))
        self.size, self.dtype = size, dtype
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        convs = [ConvLayer(3, ch[size], 1, dtype=dtype)]
        in_channel = ch[size]
        for i in range(log_size, 2, -1):
            out_channel = ch[2 ** (i - 1)]
            convs.append(ResBlock(in_channel, out_channel, blur_kernel, dtype=dtype))
            in_channel = out_channel
        self.convs = nn.Sequential(*convs)
        self.final_conv = ConvLayer(in_channel + stddev_feat, ch[4], 3, dtype=dtype)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu", dtype=dtype),
            EqualLinear(ch[4], 1, dtype=dtype))
        reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def forward(self, x, mesh=None):
        """Logits of ``x``; with ``mesh``, ``x`` is a rank's rows of the
        global batch and the minibatch-stddev groups are the global
        batch's (``minibatch_stddev``); on a mesh with ``n_space > 1``,
        ``x`` is the rank's block and the logits of its rows are replicated
        over ``'space'``."""
        with spatial.sharded(mesh):  # nothing without a 'space' split
            out = self.convs(x.to(self.dtype))
            out = minibatch_stddev(out, self.stddev_group, self.stddev_feat, mesh)
            out = self.final_conv(out)
        if mesh is None or mesh.n_space == 1:
            return self.final_linear(out.reshape(out.shape[0], -1))
        out = spatial.gather_space(out, mesh)
        out = out.reshape(out.shape[0], -1)
        for lin in self.final_linear:  # EqualLinear's forward, on replicated features
            y = spatial.replicated_linear(out.to(lin.dtype), (lin.weight * lin.scale).to(lin.dtype),
                                          mesh)
            b = spatial.split_grad(lin.bias * lin.lr_mul, mesh)
            out = (fused_leaky_relu(y, b, dim=-1) if lin.activation == "fused_lrelu"
                   else y + b.to(y.dtype))
        return out
