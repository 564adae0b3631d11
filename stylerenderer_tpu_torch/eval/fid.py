"""FID: feature statistics and the Frechet distance (counterpart of
``stylerenderer_tpu/eval/fid.py``).

The statistics and the distance are host-side numpy and scipy, as in the
JAX package; ``save_stats`` and ``load_stats`` use its pickle
(``{"mean", "cov", "meta"}``), so stats written by either package load in
the other. Feature extraction runs the generator and the network wherever
the callables put them (the card, unless asked otherwise).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """``|mu1 - mu2|^2 + tr(C1 + C2 - 2 sqrt(C1 C2))``; where the matrix
    square root is not finite, it is taken again with ``eps`` added to both
    diagonals (the reference's singular-offset fallback)."""
    import scipy.linalg

    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    cov1, cov2 = np.asarray(cov1), np.asarray(cov2)
    cc = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(cc).all():
        offset = np.eye(cov1.shape[0]) * eps
        cc = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(cc):
        cc = cc.real
    mean_norm = np.sum((mu1 - mu2) ** 2)
    return float(mean_norm + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(cc))


def feature_stats(feats):
    """(mean ``[D]``, covariance ``[D, D]``) of feature rows, in float64."""
    feats = np.asarray(feats, np.float64)
    return feats.mean(0), np.cov(feats, rowvar=False)


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def extract_features_from_samples(sample_fn, inception, n_samples: int, batch: int,
                                  generator: torch.Generator) -> np.ndarray:
    """Pool3 features ``[n_samples, 2048]`` of images drawn batch by batch
    with ``sample_fn(generator, batch)``: every call asks for a full batch
    and the last one's residual is sliced off."""
    n_batches = n_samples // batch
    resid = n_samples - n_batches * batch
    feats = []
    for i in range(n_batches + (1 if resid else 0)):
        b = batch if i < n_batches else resid
        feats.append(_numpy(inception(sample_fn(generator, batch))[:b]))
    return np.concatenate(feats, 0)[:n_samples]


@torch.no_grad()
def extract_features_from_dataset(iterator, inception, n_samples: int | None = None):
    """Pool3 features over an iterator of image batches ``[B, 3, H, W]`` in
    [-1, 1], up to ``n_samples`` of them."""
    feats, total = [], 0
    for imgs in iterator:
        f = _numpy(inception(imgs))
        feats.append(f)
        total += f.shape[0]
        if n_samples is not None and total >= n_samples:
            break
    feats = np.concatenate(feats, 0)
    return feats[:n_samples] if n_samples else feats


def save_stats(path: str, mu, cov, meta=None) -> None:
    with open(path, "wb") as f:
        pickle.dump({"mean": np.asarray(mu), "cov": np.asarray(cov), "meta": meta}, f)


def load_stats(path: str):
    """(mean, cov) of a stats pickle. It is unpickled: load only files that
    this package, the JAX package or a trusted user wrote."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["mean"], d["cov"]


def compute_fid(sample_feats, real_mu, real_cov) -> float:
    mu, cov = feature_stats(sample_feats)
    return frechet_distance(mu, cov, real_mu, real_cov)
