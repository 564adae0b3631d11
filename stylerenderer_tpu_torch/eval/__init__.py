"""Evaluation: FID with the FID InceptionV3, perceptual path length, LPIPS
and its harness."""

from stylerenderer_tpu_torch.eval.fid import (
    compute_fid,
    extract_features_from_dataset,
    extract_features_from_samples,
    feature_stats,
    frechet_distance,
    load_stats,
    save_stats,
)
from stylerenderer_tpu_torch.eval.inception import InceptionV3, load_patched_inception_v3
from stylerenderer_tpu_torch.eval.lpips import LPIPS, load_lpips
from stylerenderer_tpu_torch.eval.ppl import (
    compute_ppl,
    lerp,
    make_ppl_sampler,
    ppl_distances,
    ppl_draw,
    ppl_filtered_mean,
    slerp,
)

__all__ = [
    "InceptionV3",
    "LPIPS",
    "compute_fid",
    "compute_ppl",
    "extract_features_from_dataset",
    "extract_features_from_samples",
    "feature_stats",
    "frechet_distance",
    "lerp",
    "load_lpips",
    "load_patched_inception_v3",
    "load_stats",
    "make_ppl_sampler",
    "ppl_distances",
    "ppl_draw",
    "ppl_filtered_mean",
    "save_stats",
    "slerp",
]
