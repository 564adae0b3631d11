"""StyleGAN2 layers (NCHW, reference state-dict names)."""

from stylerenderer_tpu_torch.nn.layers import (
    Blur,
    ConstantInput,
    ConvLayer,
    Downsample,
    EqualConv2d,
    EqualLinear,
    ModulatedConv2d,
    NoiseInjection,
    PixelNorm,
    ResBlock,
    Upsample,
    minibatch_stddev,
)

__all__ = [
    "Blur", "ConstantInput", "ConvLayer", "Downsample", "EqualConv2d", "EqualLinear",
    "ModulatedConv2d", "NoiseInjection", "PixelNorm", "ResBlock", "Upsample",
    "minibatch_stddev",
]
