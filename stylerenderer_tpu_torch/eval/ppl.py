"""Perceptual path length (counterpart of ``stylerenderer_tpu/eval/ppl.py``).

Pairs of latents, interpolated linearly in W (or spherically in Z) at
``t`` and ``t + eps``; the LPIPS distance of the two images over ``eps^2``,
optionally after a center crop, resized to 256 px when larger; the mean
of the distances between their 1st and 99th percentiles.

The sampler is split in two: ``ppl_draw`` draws ``(z0, z1, t)`` from a
``torch.Generator`` and ``ppl_distances`` maps them to distances, so the
distances can be held against another package's on its own draws.
"""

from __future__ import annotations

import numpy as np
import torch

from stylerenderer_tpu_torch.ops.resize import resize_linear


def lerp(a, b, t):
    return a + (b - a) * t


def slerp(a, b, t, eps: float = 1e-8):
    """Spherical interpolation along the great circle between ``a`` and
    ``b`` (rows), the magnitudes interpolated linearly."""
    na = torch.linalg.norm(a, dim=-1, keepdim=True)
    nb = torch.linalg.norm(b, dim=-1, keepdim=True)
    an = a / torch.clamp(na, min=eps)
    bn = b / torch.clamp(nb, min=eps)
    dot = torch.clamp(torch.sum(an * bn, -1, keepdim=True), -1.0, 1.0)
    theta = torch.arccos(dot)
    st = torch.clamp(torch.sin(theta), min=eps)
    w0 = torch.sin((1 - t) * theta) / st
    w1 = torch.sin(t * theta) / st
    return (w0 * an + w1 * bn) * lerp(na, nb, t)


def ppl_filtered_mean(distances, lo: float = 1.0, hi: float = 99.0) -> float:
    """Mean of the distances between the ``lo`` and ``hi`` percentiles."""
    d = np.asarray(distances)
    plo, phi = np.percentile(d, lo), np.percentile(d, hi)
    return float(d[(d >= plo) & (d <= phi)].mean())


def ppl_draw(generator: torch.Generator, batch: int, latent_dim: int,
             sampling: str = "end", device=None):
    """``(z0, z1, t)``: two ``[batch, latent_dim]`` normal draws and ``t``
    ``[batch, 1]``, uniform in [0, 1) (``"full"``) or zero (``"end"``),
    drawn on ``generator``'s device and moved to ``device``."""
    if sampling not in ("end", "full"):
        raise ValueError(f"sampling {sampling!r}: 'end' or 'full'")
    gdev = generator.device
    z0 = torch.randn(batch, latent_dim, generator=generator, device=gdev)
    z1 = torch.randn(batch, latent_dim, generator=generator, device=gdev)
    if sampling == "full":
        t = torch.rand(batch, 1, generator=generator, device=gdev)
    else:
        t = torch.zeros(batch, 1, device=gdev)
    return z0.to(device), z1.to(device), t.to(device)


@torch.no_grad()
def ppl_distances(map_fn, synth_fn, lpips_fn, z0, z1, t, *, space: str = "w",
                  eps: float = 1e-4, crop: bool = False) -> torch.Tensor:
    """``[B]`` path-length samples at ``(z0, z1, t)``.

    map_fn(z) -> w; synth_fn(latents, input_is_latent) -> images
    ``[B, 3, H, W]``; lpips_fn(a, b) -> ``[B]``. Both synthesis calls should
    use the same noise."""
    if space == "w":
        w0, w1 = map_fn(z0), map_fn(z1)
        img0 = synth_fn(lerp(w0, w1, t), True)
        img1 = synth_fn(lerp(w0, w1, t + eps), True)
    elif space == "z":
        img0 = synth_fn(slerp(z0, z1, t), False)
        img1 = synth_fn(slerp(z0, z1, t + eps), False)
    else:
        raise ValueError(f"space {space!r}: 'w' or 'z'")
    if crop:
        h = img0.shape[2]
        c0, c1 = h // 8 * 2, h // 8 * 6
        img0, img1 = img0[:, :, c0:c1, c0:c1], img1[:, :, c0:c1, c0:c1]
    if img0.shape[2] > 256:
        img0, img1 = (resize_linear(x.permute(0, 2, 3, 1), 256, 256).permute(0, 3, 1, 2)
                      for x in (img0, img1))
    return lpips_fn(img0, img1) / (eps ** 2)


def make_ppl_sampler(map_fn, synth_fn, lpips_fn, latent_dim: int, *, space: str = "w",
                     sampling: str = "end", eps: float = 1e-4, crop: bool = False,
                     device=None):
    """``sample(generator, batch) -> [batch]`` distances: ``ppl_draw`` then
    ``ppl_distances``."""

    def sample(generator, batch):
        z0, z1, t = ppl_draw(generator, batch, latent_dim, sampling, device)
        return ppl_distances(map_fn, synth_fn, lpips_fn, z0, z1, t, space=space, eps=eps,
                             crop=crop)

    return sample


def compute_ppl(sampler, generator: torch.Generator, n_samples: int, batch: int) -> float:
    """The filtered mean over ``n_samples`` distances, drawn in full batches."""
    dists = [sampler(generator, batch).float().cpu().numpy()
             for _ in range(-(-n_samples // batch))]
    return ppl_filtered_mean(np.concatenate(dists)[:n_samples])
