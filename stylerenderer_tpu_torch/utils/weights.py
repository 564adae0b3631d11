"""Carry JAX parameters into the port: ``Generator``, ``GeneratorWithMap``,
``Discriminator``, the ``Regressor``, the FID ``InceptionV3``, ``LPIPS`` and
the three supervisor nets.

The inverses of ``stylerenderer_tpu/utils/torch_import.py::import_generator``
(``with_map`` False and True) and ``import_discriminator``, of the JAX
eval package's torch loaders (``eval/inception.py::
load_torch_inception_weights``, ``eval/lpips.py::_load_backbone`` and
``_load_linear_heads``) and of ``supervisors/convert.py::
convert_face_normals``, ``convert_pfld`` and ``convert_facenet``: a flax
params tree of numpy arrays becomes a state dict with the reference PyTorch
model's (or the published supervisor's) names and layouts, which the
port's ``load_state_dict(strict=True)`` accepts.

- flax linear ``[in, out]``        -> ``[out, in]``
- conv HWIO ``[kh, kw, in, out]``  -> OIHW (modulated conv: ``[1, out, in, kh, kw]``)
- ConstantInput NHWC ``[1, 4, 4, C]`` -> ``[1, C, 4, 4]``
- ToRGB bias ``[1, 1, 1, 3]``      -> ``[1, 3, 1, 1]``
- Inception's flat ``bn_scale/bn_bias/bn_mean/bn_var`` -> ``bn.weight``,
  ``bn.bias``, ``bn.running_mean``, ``bn.running_var``
- an LPIPS head ``lin{i}`` ``[C]`` -> ``lin{i}.model.1.weight``
  ``[1, C, 1, 1]``; the backbone's ``conv{i}`` -> torchvision's
  ``features.{index}``
- a spectral-norm conv (``ConvLayer(activate="sp")``): ``conv_sp``'s
  ``weight_bar`` (already OIHW) and ``bias``, and ``u``, ``v`` from the
  ``spectral`` collection;
- flax batch norm ``scale/bias/mean/var`` -> ``weight``, ``bias``,
  ``running_mean``, ``running_var`` (and ``num_batches_tracked`` 0);
- the FIR ``kernel`` buffers are rebuilt from ``blur_kernel``; the
  ``noises.noise_{i}`` buffers come from ``noise`` (NHWC ``[1, H, W, 1]``
  arrays, the JAX convention) or, without it, the port's ``stored_noise``.
"""

from __future__ import annotations

import numpy as np
import torch

from stylerenderer_tpu_torch.eval.lpips import CONV_INDICES
from stylerenderer_tpu_torch.models.generator import stored_noise
from stylerenderer_tpu_torch.ops.upfirdn2d import make_kernel


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _oihw(kernel) -> torch.Tensor:
    """A conv kernel HWIO -> OIHW."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


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


def _conv_layer(sd, prefix, p, blur=None, spectral=None):
    """``[Blur] EqualConv2d [FusedLeakyReLU]`` or ``[Blur]
    SpectralEqualConv2d``: with a downsampling ``blur`` kernel the conv
    sits at index 1, after the Blur's ``kernel`` buffer. ``spectral``: the
    layer's ``spectral`` collection (``u``, ``v``), if any."""
    ci = 0
    if blur is not None:
        sd[f"{prefix}.0.kernel"] = blur.clone()
        ci = 1
    if "conv_sp" in p:
        sp = p["conv_sp"]
        sd[f"{prefix}.{ci}.weight_bar"] = _t(sp["weight_bar"])
        if "bias" in sp:
            sd[f"{prefix}.{ci}.bias"] = _t(sp["bias"])
        for k in ("u", "v"):
            if spectral is not None and k in spectral.get("conv_sp", {}):
                sd[f"{prefix}.{ci}.{k}"] = _t(spectral["conv_sp"][k])
        return
    sd[f"{prefix}.{ci}.weight"] = _oihw(p["conv"]["weight"])
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


def generator_state_dict_from_jax(params, noise=None, blur_kernel=(1, 3, 3, 1)) -> dict:
    """JAX ``Generator`` params -> the port's ``Generator`` state dict (the
    layers both generators share; ``state_dict_from_jax`` adds the GAR's)."""
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
    nz = noise_from_jax(noise) if noise is not None else stored_noise(num_layers)
    for i in range(num_layers):
        sd[f"noises.noise_{i}"] = nz[i][:1].clone()
    return sd


def state_dict_from_jax(params, noise=None, blur_kernel=(1, 3, 3, 1)) -> dict:
    """JAX ``GeneratorWithMap`` params (``n_stylemap=3``) -> the port's
    state dict."""
    sd = generator_state_dict_from_jax(params, noise, blur_kernel)
    n_levels = sum(1 for k in params if k.startswith("to_rgbs_"))
    _res_block(sd, "norm1", params["norm1"])
    for i in range(n_levels):
        _res_block(sd, f"norm_to_style.{i}", params[f"norm_to_style_{i}"])
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


def _out_channels(p) -> int:
    """Output channels of a JAX ``ConvLayer``'s params."""
    if "conv_sp" in p:
        return np.shape(p["conv_sp"]["weight_bar"])[0]
    return np.shape(p["conv"]["weight"])[-1]


def regressor_state_dict_from_jax(params, spectral=None, blur_kernel=(1, 3, 3, 1)) -> dict:
    """JAX ``Regressor`` params (and its ``spectral`` collection, when a
    layer has one) -> the port's ``Regressor`` state dict.

    ``fc0`` takes the statistics, then the 4x4 features flattened in
    (C, H, W) order, the JAX model's in (H, W, C) order: the flattened
    features' input columns are permuted (the statistics' keep theirs), so
    both compute the same function."""
    spectral = spectral or {}
    n_scales = sum(1 for k in params if k.startswith("from_rgb"))
    n_mlp = sum(1 for k in params if k.startswith("fc"))
    blur = make_kernel(list(blur_kernel))
    sd: dict[str, torch.Tensor] = {}
    _conv_layer(sd, "conv1", params["conv1"], spectral=spectral.get("conv1"))
    for idx in range(n_scales):
        for name, b in ((f"conv{idx}_a", None), (f"from_rgb{idx}", None),
                        (f"conv{idx}_b", blur)):
            _conv_layer(sd, name, params[name], b, spectral.get(name))
    w = np.asarray(params["fc0"]["weight"])  # [stats + (h, w, c), out]
    c = _out_channels(params[f"conv{n_scales - 1}_b"])
    n_stats = w.shape[0] - 16 * c
    flat = np.transpose(w[n_stats:].reshape(4, 4, c, -1), (2, 0, 1, 3)).reshape(16 * c, -1)
    _linear(sd, "fc0", dict(params["fc0"], weight=np.concatenate([w[:n_stats], flat])))
    for i in range(1, n_mlp):
        _linear(sd, f"fc{i}", params[f"fc{i}"])
    return sd


def _conv(sd, name, p):
    """A flax ``Conv`` (``kernel`` HWIO, optional ``bias``) -> ``name.weight``
    (OIHW) and ``name.bias``."""
    sd[f"{name}.weight"] = _oihw(p["kernel"])
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd, name, scale, bias, mean, var):
    for ours, a in (("weight", scale), ("bias", bias), ("running_mean", mean),
                    ("running_var", var)):
        sd[f"{name}.{ours}"] = _t(a)
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _bn_tree(sd, name, p):
    _bn(sd, name, p["scale"], p["bias"], p["mean"], p["var"])


def face_normals_state_dict_from_jax(params) -> dict:
    """JAX ``ResNetUNet`` params -> the port's (face_normals' published)
    state dict, the inverse of ``convert_face_normals``."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "conv1", params["conv1"])
    _bn_tree(sd, "bn1", params["bn1"])
    for li in range(1, 5):
        for bi in range(2):
            p, pre = params[f"layer{li}_{bi}"], f"layer{li}.{bi}"
            _conv(sd, f"{pre}.conv1", p["conv1"])
            _bn_tree(sd, f"{pre}.bn1", p["bn1"])
            _conv(sd, f"{pre}.conv2", p["conv2"])
            _bn_tree(sd, f"{pre}.bn2", p["bn2"])
            if "down_conv" in p:
                _conv(sd, f"{pre}.downsample.0", p["down_conv"])
                _bn_tree(sd, f"{pre}.downsample.1", p["down_bn"])
    for name in ("layer0_1x1", "layer1_1x1", "layer2_1x1", "layer3_1x1", "layer4_1x1",
                 "conv_up0", "conv_up1", "conv_up2", "conv_up3", "conv_original_size0",
                 "conv_original_size1", "conv_original_size2"):
        _conv(sd, f"{name}.0", params[name])
    _conv(sd, "conv_last", params["conv_last"])
    return sd


def pfld_state_dict_from_jax(params) -> dict:
    """JAX ``PFLDInference`` params -> the port's (PFLD-pytorch's) state
    dict, the inverse of ``convert_pfld``."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2"):
        _conv(sd, name, params[name])
    for name in ("bn1", "bn2"):
        _bn_tree(sd, name, params[name])
    blocks = ["conv3_1", "conv4_1", "conv5_1", "conv6_1"]
    blocks += [f"block3_{i}" for i in range(2, 6)] + [f"block5_{i}" for i in range(2, 7)]
    for name in blocks:
        p = params[name]
        for i, key in ((0, "pw"), (3, "dw"), (6, "pw2")):
            _conv(sd, f"{name}.conv.{i}", p[key])
        for i, key in ((1, "bn1"), (4, "bn2"), (7, "bn3")):
            _bn_tree(sd, f"{name}.conv.{i}", p[key])
    _conv(sd, "conv7.0", params["conv7"])
    _bn_tree(sd, "conv7.1", params["bn7"])
    _conv(sd, "conv8", params["conv8"])
    sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


# facenet blocks: the JAX names of a block's BasicConv2ds and the torch ones
_FACENET_B35 = (("b0", "branch0"), ("b1_0", "branch1.0"), ("b1_1", "branch1.1"),
                ("b2_0", "branch2.0"), ("b2_1", "branch2.1"), ("b2_2", "branch2.2"))
_FACENET_B17 = (("b0", "branch0"), ("b1_0", "branch1.0"), ("b1_1", "branch1.1"),
                ("b1_2", "branch1.2"))


def facenet_state_dict_from_jax(params) -> dict:
    """JAX ``InceptionResnetV1`` params -> the port's (facenet-pytorch's)
    state dict, the inverse of ``convert_facenet``."""
    sd: dict[str, torch.Tensor] = {}

    def basic(name, p):
        _conv(sd, f"{name}.conv", p["conv"])
        _bn(sd, f"{name}.bn", p["bn_scale"], p["bn_bias"], p["bn_mean"], p["bn_var"])

    def block(name, p, branches):
        for ours, theirs in branches:
            basic(f"{name}.{theirs}", p[ours])
        _conv(sd, f"{name}.conv2d", p["up"])

    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a",
                 "conv2d_4b"):
        basic(name, params[name])
    for i in range(5):
        block(f"repeat_1.{i}", params[f"repeat_1_{i}"], _FACENET_B35)
    basic("mixed_6a.branch0", params["mixed_6a_b0"])
    for j in range(3):
        basic(f"mixed_6a.branch1.{j}", params[f"mixed_6a_b1_{j}"])
    for i in range(10):
        block(f"repeat_2.{i}", params[f"repeat_2_{i}"], _FACENET_B17)
    for j in range(2):
        basic(f"mixed_7a.branch0.{j}", params[f"mixed_7a_b0_{j}"])
        basic(f"mixed_7a.branch1.{j}", params[f"mixed_7a_b1_{j}"])
    for j in range(3):
        basic(f"mixed_7a.branch2.{j}", params[f"mixed_7a_b2_{j}"])
    for i in range(5):
        block(f"repeat_3.{i}", params[f"repeat_3_{i}"], _FACENET_B17)
    block("block8", params["block8"], _FACENET_B17)
    sd["last_linear.weight"] = _t(np.asarray(params["last_linear"]["kernel"]).T)
    _bn(sd, "last_bn", params["last_bn_scale"], params["last_bn_bias"],
        params["last_bn_mean"], params["last_bn_var"])
    return sd


def inception_state_dict_from_jax(params) -> dict:
    """JAX FID ``InceptionV3`` params -> the port's ``InceptionV3`` state
    dict (the FID Inception's torch names, ``Conv2d_1a_3x3.conv.weight``,
    ``Mixed_5b.branch1x1.bn.running_mean``, ...)."""
    sd: dict[str, torch.Tensor] = {}

    def basic(prefix, p):
        sd[f"{prefix}.conv.weight"] = _oihw(p["conv"]["kernel"])
        for ours, theirs in (("weight", "bn_scale"), ("bias", "bn_bias"),
                             ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            sd[f"{prefix}.bn.{ours}"] = _t(p[theirs])
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)

    for top, sub in params.items():
        if top.startswith("Conv2d"):
            basic(top, sub)
        else:  # Mixed_* blocks: each child is a BasicConv2d
            for child, p in sub.items():
                basic(f"{top}.{child}", p)
    return sd


def lpips_state_dict_from_jax(params, net: str = "vgg") -> dict:
    """JAX ``LPIPS`` params -> the port's ``LPIPS`` state dict: torchvision's
    backbone names (``features.{index}.weight``) and the published heads'
    (``lin{i}.model.1.weight``)."""
    sd: dict[str, torch.Tensor] = {}
    for i, tid in enumerate(CONV_INDICES[net]):
        p = params["backbone"][f"conv{i}"]
        sd[f"features.{tid}.weight"] = _oihw(p["kernel"])
        sd[f"features.{tid}.bias"] = _t(p["bias"])
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = _t(np.asarray(params[f"lin{i}"]).reshape(1, -1, 1, 1))
    return sd
