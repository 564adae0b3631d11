"""GAN losses and the lazy regularizers (counterpart of
``stylerenderer_tpu/train/losses.py``).

The gradient penalties take their inner gradients with
``torch.autograd.grad(create_graph=True)``, so a second backward through
the penalty reaches the networks' parameters (R1 through D; the path
length through the synthesis network and the mapping MLP).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def d_logistic_loss(real_pred, fake_pred):
    """``softplus(-real).mean() + softplus(fake).mean()``."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    """``softplus(-fake).mean()``."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(disc, real_img, gather=None):
    """R1 gradient penalty ``E[||grad_x D(x)||^2]`` on the reals; ``disc``
    is any callable image -> logits. Differentiable in ``disc``'s
    parameters. ``gather`` (``Mesh.gather_rows``) takes the mean over the
    global batch when ``real_img`` is a rank's rows of it."""
    real_img = real_img.detach().requires_grad_(True)
    (grad_real,) = torch.autograd.grad(disc(real_img).sum(), real_img, create_graph=True)
    sq = grad_real.pow(2).reshape(grad_real.shape[0], -1).sum(1)
    return (sq if gather is None else gather(sq)).mean()


def path_lengths_multi(synth_fn, probe, inputs, lambdas=None):
    """Path lengths ``[B]`` of ``synth_fn(*inputs) -> [B, C, H, W]`` over
    several input tensors (W and the normal-map pyramid): the gradients of
    ``sum(img * probe / sqrt(H W))`` with respect to each input, their
    per-sample norms summed with the weights ``lambdas`` (default 1).

    ``probe`` is the image-shaped N(0, 1) draw. Inputs that do not require
    grad are taken as detached leaves. Each norm is
    ``sqrt(max(|g|^2, 1e-24))``, so a zero gradient has a finite
    derivative."""
    inputs = [x if x.requires_grad else x.detach().requires_grad_(True) for x in inputs]
    img = synth_fn(*inputs)
    h, w = img.shape[2], img.shape[3]
    noise = probe.to(img.dtype) / math.sqrt(h * w)
    grads = torch.autograd.grad((img * noise).sum(), inputs, create_graph=True,
                                allow_unused=True, materialize_grads=True)
    if lambdas is None:
        lambdas = [1.0] * len(inputs)
    pl = 0.0
    for lam, g in zip(lambdas, grads):
        g2 = g.pow(2).reshape(g.shape[0], -1).sum(1)
        pl = pl + torch.sqrt(torch.clamp(g2, min=1e-24)) * lam
    return pl


def path_regularize(path_lengths, mean_path_length, decay: float = 0.01):
    """``((pl - mean') ** 2).mean()`` and the detached running mean
    ``mean' = mean + decay * (pl.mean() - mean)``."""
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    penalty = (path_lengths - path_mean).pow(2).mean()
    return penalty, path_mean.detach()
