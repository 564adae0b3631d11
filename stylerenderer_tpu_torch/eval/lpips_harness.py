"""LPIPS' auxiliary harness: the non-learned baseline distances and the
human-judgement scores (counterpart of
``stylerenderer_tpu/eval/lpips_harness.py``).

- ``l2_distance``, ``dssim_distance``: the baseline "models" (RGB branch).
  SSIM follows skimage's ``compare_ssim`` as the reference calls it: a
  uniform 7x7 window over the valid interior, K1 = 0.01, K2 = 0.03, the
  unbiased covariance, the mean over channels, on [0, 255] images made
  from the [-1, 1] ones.
- ``score_2afc``: the share of triplets where the distances agree with the
  human two-alternative judgement, ties counting half.
- ``score_jnd``: the average precision of same/different pairs ranked by
  distance (``voc_ap``).

Images are ``[B, C, H, W]`` tensors; the scores are numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l2_distance(p0, p1):
    """Per-sample mean squared difference of [-1, 1] images -> ``[B]``."""
    return torch.mean((p0 - p1) ** 2, dim=(1, 2, 3))


def psnr(p0, p1, peak: float = 255.0):
    """PSNR of [0, 255] images -> ``[B]``."""
    mse = torch.mean((p0.float() - p1.float()) ** 2, dim=tuple(range(1, p0.ndim)))
    return 10 * torch.log10(peak ** 2 / torch.clamp(mse, min=1e-20))


def ssim(p0, p1, data_range: float = 255.0, win: int = 7, k1: float = 0.01,
         k2: float = 0.03):
    """SSIM of ``[B, C, H, W]`` images, the mean over channels -> ``[B]``:
    the window means of a valid ``win x win`` pool, so no interior crop is
    needed."""
    x, y = p0.float(), p1.float()
    n = float(win * win)
    cov_norm = n / (n - 1.0)

    def mean(t):
        return F.avg_pool2d(t, win, 1)

    ux, uy = mean(x), mean(y)
    vx = cov_norm * (mean(x * x) - ux * ux)
    vy = cov_norm * (mean(y * y) - uy * uy)
    vxy = cov_norm * (mean(x * y) - ux * uy)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return torch.mean(s, dim=(1, 2, 3))


def dssim_distance(p0, p1):
    """``(1 - ssim) / 2`` of [-1, 1] images mapped to [0, 255]."""
    return (1.0 - ssim((p0 + 1.0) * 127.5, (p1 + 1.0) * 127.5, 255.0)) / 2.0


def score_2afc(d0s, d1s, gts):
    """(score, per-triplet scores); ``gts`` in [0, 1] is the share of
    people who preferred patch 1."""
    d0s, d1s, gts = (np.asarray(a, np.float64) for a in (d0s, d1s, gts))
    scores = (d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts + (d1s == d0s) * 0.5
    return float(np.mean(scores)), scores


def voc_ap(rec, prec) -> float:
    """VOC average precision, the exact integration of the envelope."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def score_jnd(ds, sames) -> float:
    """Average precision of same-pair detection ranked by ascending
    distance."""
    ds, sames = np.asarray(ds, np.float64), np.asarray(sames, np.float64)
    s = sames[np.argsort(ds)]
    tps = np.cumsum(s)
    fps = np.cumsum(1 - s)
    fns = np.sum(s) - tps
    precs = tps / np.maximum(tps + fps, 1e-12)
    recs = tps / np.maximum(tps + fns, 1e-12)
    return voc_ap(recs, precs)
