"""Carry JAX ``GeneratorWithMap`` and ``Discriminator`` parameters into
the port.

The inverses of ``stylerenderer_tpu/utils/torch_import.py::import_generator``
(``with_map=True``) and ``import_discriminator``: a flax params tree of
numpy arrays becomes a state dict with the reference PyTorch model's names
and layouts, which the port's ``load_state_dict(strict=True)`` accepts.

- flax linear ``[in, out]``        -> ``[out, in]``
- conv HWIO ``[kh, kw, in, out]``  -> OIHW (modulated conv: ``[1, out, in, kh, kw]``)
- ConstantInput NHWC ``[1, 4, 4, C]`` -> ``[1, C, 4, 4]``
- ToRGB bias ``[1, 1, 1, 3]``      -> ``[1, 3, 1, 1]``
- the FIR ``kernel`` buffers are rebuilt from ``blur_kernel``; the
  ``noises.noise_{i}`` buffers come from ``noise`` (NHWC ``[1, H, W, 1]``
  arrays, the JAX convention) or, without it, the port's ``stored_noise``.
"""

from __future__ import annotations

import numpy as np
import torch

from stylerenderer_tpu_torch.models.generator import stored_noise
from stylerenderer_tpu_torch.ops.upfirdn2d import make_kernel


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["weight"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _modconv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["weight"]), (3, 2, 0, 1))[None])
    _linear(sd, f"{prefix}.modulation", p["modulation"])


def _styled_conv(sd, prefix, p):
    _modconv(sd, f"{prefix}.conv", p["conv"])
    sd[f"{prefix}.noise.weight"] = _t(np.asarray(p["noise"]["weight"]).reshape(1))
    sd[f"{prefix}.activate.bias"] = _t(p["act_bias"])


def _to_rgb(sd, prefix, p):
    _modconv(sd, f"{prefix}.conv", p["conv"])
    sd[f"{prefix}.bias"] = _t(np.asarray(p["bias"]).reshape(1, 3, 1, 1))


def _conv_layer(sd, prefix, p, blur=None):
    """``[Blur] EqualConv2d [FusedLeakyReLU]``: with a downsampling ``blur``
    kernel the conv sits at index 1, after the Blur's ``kernel`` buffer."""
    ci = 0
    if blur is not None:
        sd[f"{prefix}.0.kernel"] = blur.clone()
        ci = 1
    sd[f"{prefix}.{ci}.weight"] = _t(np.transpose(np.asarray(p["conv"]["weight"]), (3, 2, 0, 1)))
    if "bias" in p["conv"]:
        sd[f"{prefix}.{ci}.bias"] = _t(p["conv"]["bias"])
    if "act_bias" in p:
        sd[f"{prefix}.{ci + 1}.bias"] = _t(p["act_bias"])


def _res_block(sd, prefix, p, blur=None):
    _conv_layer(sd, f"{prefix}.conv1", p["conv1"])
    _conv_layer(sd, f"{prefix}.conv2", p["conv2"], blur)
    _conv_layer(sd, f"{prefix}.skip", p["skip"], blur)


def noise_from_jax(noise) -> list[torch.Tensor]:
    """JAX per-layer noise (NHWC ``[B, H, W, 1]`` arrays) -> NCHW tensors."""
    return [_t(np.transpose(np.asarray(n), (0, 3, 1, 2))) for n in noise]


def state_dict_from_jax(params, noise=None, blur_kernel=(1, 3, 3, 1)) -> dict:
    """JAX ``GeneratorWithMap`` params (``n_stylemap=3``) -> the port's
    state dict."""
    n_mlp = sum(1 for k in params["style"] if k.startswith("fc"))
    n_levels = sum(1 for k in params if k.startswith("to_rgbs_"))
    num_layers = 2 * n_levels + 1
    sd: dict[str, torch.Tensor] = {}
    for i in range(n_mlp):
        _linear(sd, f"style.{i + 1}", params["style"][f"fc{i}"])
    sd["input.input"] = _t(np.transpose(np.asarray(params["input"]["input"]), (0, 3, 1, 2)))
    _styled_conv(sd, "conv1", params["conv1"])
    _to_rgb(sd, "to_rgb1", params["to_rgb1"])
    up_kernel = make_kernel(list(blur_kernel)) * 4
    for i in range(2 * n_levels):
        _styled_conv(sd, f"convs.{i}", params[f"convs_{i}"])
        if i % 2 == 0:  # the upsampling conv of each level
            sd[f"convs.{i}.conv.blur.kernel"] = up_kernel.clone()
    for i in range(n_levels):
        _to_rgb(sd, f"to_rgbs.{i}", params[f"to_rgbs_{i}"])
        sd[f"to_rgbs.{i}.upsample.kernel"] = up_kernel.clone()
    _res_block(sd, "norm1", params["norm1"])
    for i in range(n_levels):
        _res_block(sd, f"norm_to_style.{i}", params[f"norm_to_style_{i}"])
    nz = noise_from_jax(noise) if noise is not None else stored_noise(num_layers)
    for i in range(num_layers):
        sd[f"noises.noise_{i}"] = nz[i][:1].clone()
    return sd


def discriminator_state_dict_from_jax(params, size: int, blur_kernel=(1, 3, 3, 1)) -> dict:
    """JAX ``Discriminator`` params -> the port's state dict.

    ``final_linear.0`` takes the 4x4 features flattened in (C, H, W) order,
    the JAX model's in (H, W, C) order: its input columns are permuted so
    both compute the same function. ``import_discriminator`` of the result
    therefore gives back every array unchanged except that weight, whose
    rows come back in (C, H, W) order."""
    log_size = int(np.log2(size))
    blur = make_kernel(list(blur_kernel))
    sd: dict[str, torch.Tensor] = {}
    _conv_layer(sd, "convs.0", params["from_rgb"])
    for idx, i in enumerate(range(log_size, 2, -1)):
        _res_block(sd, f"convs.{idx + 1}", params[f"block{i}"], blur)
    _conv_layer(sd, "final_conv", params["final_conv"])
    w = np.asarray(params["final_linear0"]["weight"])  # [(h, w, c), out]
    c = w.shape[0] // 16
    w = np.transpose(w.reshape(4, 4, c, -1), (2, 0, 1, 3)).reshape(16 * c, -1)
    _linear(sd, "final_linear.0", dict(params["final_linear0"], weight=w))
    _linear(sd, "final_linear.1", params["final_linear1"])
    return sd
