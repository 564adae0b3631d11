"""Ops: fused activation, upfirdn2d, the linear resize, and the rasterizer
with its two kernels and the binned search."""

from stylerenderer_tpu_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from stylerenderer_tpu_torch.ops.rasterize import (
    rasterize,
    rasterize_index_coeff,
    rasterize_pyramid,
    rasterize_pyramid_fused,
    rasterize_winners,
)
from stylerenderer_tpu_torch.ops.rasterize_binned import (
    big_overflow_count,
    rasterize_winners_binned,
)
from stylerenderer_tpu_torch.ops.rasterize_multi import (
    rasterize_winners_multi,
    rasterize_winners_multi_ref,
)
from stylerenderer_tpu_torch.ops.rasterize_single import (
    rasterize_winners_single,
    rasterize_winners_single_ref,
)
from stylerenderer_tpu_torch.ops.resize import resize_linear
from stylerenderer_tpu_torch.ops.upfirdn2d import (
    blur,
    downsample2d,
    make_kernel,
    upfirdn2d,
    upsample2d,
)

__all__ = [
    "big_overflow_count", "blur", "downsample2d", "fused_leaky_relu", "make_kernel",
    "rasterize", "rasterize_index_coeff", "rasterize_pyramid", "rasterize_pyramid_fused",
    "rasterize_winners", "rasterize_winners_binned", "rasterize_winners_multi",
    "rasterize_winners_multi_ref", "rasterize_winners_single", "rasterize_winners_single_ref",
    "resize_linear", "scaled_leaky_relu", "upfirdn2d", "upsample2d",
]
