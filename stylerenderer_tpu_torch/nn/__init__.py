"""StyleGAN2 layers (NCHW, reference state-dict names) and spectral normalization."""

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
from stylerenderer_tpu_torch.nn.spectral import (
    SpectralEqualConv2d,
    SpectralNorm,
    batch_eigen_max,
    normalize_vec,
    spectral_sigma_exact,
)

__all__ = [
    "Blur", "ConstantInput", "ConvLayer", "Downsample", "EqualConv2d", "EqualLinear",
    "ModulatedConv2d", "NoiseInjection", "PixelNorm", "ResBlock", "SpectralEqualConv2d",
    "SpectralNorm", "Upsample", "batch_eigen_max", "minibatch_stddev", "normalize_vec",
    "spectral_sigma_exact",
]
