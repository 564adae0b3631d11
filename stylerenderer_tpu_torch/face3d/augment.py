"""ADA-style differentiable image augmentation (counterpart of
``stylerenderer_tpu/face3d/augment.py``), NCHW.

- color: brightness, contrast, luma flip, hue rotation about the gray axis
  and saturation as one 3x4 color matrix per sample;
- geometric: translate, rotate, log-scale and h-flip by an inverse-warp
  bilinear resample with the border-safe minimum zoom, or applied to camera
  matrices instead of pixels (``pose2d_cam_from``; no caller in either
  package);
- ``ada_augment``: geometric then color, applied per sample with
  probability ``p``: the hook the ADA controller drives in the train step.

Each transform is split into a draw (``*_draws``, from a
``torch.Generator``) and a draw-free core that takes the raw N(0, 1) and
U(0, 1) draws (``color_matrix_from``, ``pose2d_from``, ``pose2d_cam_from``,
``ada_augment``), so
the cores can be fed the JAX package's own draws. Differentiable in the
image, so the generator's loss passes through the augmentation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from stylerenderer_tpu_torch.face3d.transforms import rodrigues

COLOR_P = (0.2, 0.3, 0.0, 0.15, 0.5)  # bright, contrast, luma_flip, hue, sat
POSE_P = (0.1, 0.1, 0.05, 0.15, 0.0, 0.5)  # tx, ty, rz, s_var, s_mean, flip


def _abs_p(p, device):
    return torch.as_tensor(p, dtype=torch.float32, device=device).abs()


def color_matrix_from(z01, coin, z34, p=COLOR_P):
    """Per-sample 3x4 color transforms ``[B, 3, 4]`` from the raw draws:
    ``z01`` N(0, 1) ``[B, 2]`` (brightness, log-contrast), ``coin`` U(0, 1)
    ``[B, 1]`` (luma flip), ``z34`` N(0, 1) ``[B, 2]`` (hue, log-saturation)."""
    p = _abs_p(p, z01.device)
    batch = z01.shape[0]
    z01 = z01 * p[:2]
    z34 = z34 * p[3:5]
    br = z01[:, 0:1]
    con = torch.exp(z01[:, 1:2])
    luma = (coin < p[2]).float()
    hue = z34[:, 0:1]
    sat = torch.exp(z34[:, 1:2])[..., None]
    o = torch.zeros_like(br)
    eye = torch.eye(3, device=z01.device)[None]
    C = torch.stack([con, o, o, con * br, o, con, o, con * br, o, o, con, con * br],
                    -1).reshape(batch, 3, 4)
    # luma flip: reflection about the luminance plane, I - (2/3) ones
    C = torch.einsum("bij,bjk->bik", eye - luma[:, :, None] * (2.0 / 3.0), C)
    # hue rotation about the gray axis
    R = rodrigues(torch.cat([hue, hue, hue], 1) / math.sqrt(3.0))
    C = torch.einsum("bij,bjk->bik", R, C)
    # saturation: blend toward gray
    S = eye * sat + (1.0 - sat) / 3.0
    return torch.einsum("bij,bjk->bik", S, C)


def apply_color(img, C):
    """``img`` ``[B, 3, H, W]``, ``C`` ``[B, 3, 4]`` -> the color-transformed
    image."""
    out = torch.einsum("bchw,boc->bohw", img, C[:, :, :3].to(img.dtype))
    return out + C[:, :, 3, None, None].to(img.dtype)


def bilinear_sample(img, x, y):
    """Zero-padded bilinear sampling of ``img`` ``[B, C, H, W]`` at the
    normalized coordinates ``x``, ``y`` ``[B, H', W']`` in [-1, 1] (pixel
    centers at ``(2i + 1) / n - 1``)."""
    grid = torch.stack([x, y], -1).to(img.dtype)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def pose2d_from(z, s, coin, img, p=POSE_P):
    """Random translate / rotate / scale / flip of ``img`` ``[B, C, H, W]``
    from the raw draws: ``z`` N(0, 1) ``[B, 3]`` (tx, ty, rotation), ``s``
    N(0, 1) ``[B, 1]`` (log-scale), ``coin`` U(0, 1) ``[B, 1]`` (flip). The
    zoom is at least what keeps the rotated output corners inside the
    source's pixel-center extent."""
    b, _, h, w = img.shape
    p = _abs_p(p, img.device)
    z = z * p[:3]
    f = torch.exp(s * p[3] + p[4])  # [b, 1]
    flip = coin < p[5]
    sn = torch.sin(z[:, 2:3])
    cs = torch.cos(z[:, 2:3])
    tx = z[:, 0:1]
    ty = z[:, 1:2]

    m = max(w, h) / 2.0
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    # pixel-center coordinates, so the identity transform resamples exactly
    x = ((xs + 0.5 - w / 2.0) / m)[None].expand(b, h, w)
    y = ((h / 2.0 - ys - 0.5) / m)[None].expand(b, h, w)
    x = torch.where(flip[:, :, None], -x, x)
    x = x - tx[:, :, None]
    y = y - ty[:, :, None]

    # border-safe minimum zoom: the rotated output corners stay inside the
    # pixel-center extent (w - 1, h - 1)
    cx = torch.stack([x[:, 0, 0], x[:, 0, -1], x[:, -1, 0], x[:, -1, -1]], 1)
    cy = torch.stack([y[:, 0, 0], y[:, 0, -1], y[:, -1, 0], y[:, -1, -1]], 1)
    rx = (cs * cx + sn * cy) * (2.0 * m / max(w - 1.0, 1.0))
    ry = (-sn * cx + cs * cy) * (2.0 * m / max(h - 1.0, 1.0))
    fmax = torch.amax(torch.abs(torch.cat([rx, ry], 1)), 1, keepdim=True)
    f = torch.maximum(f, fmax)

    x = x / f[:, :, None]
    y = y / f[:, :, None]
    x, y = (cs[:, :, None] * x + sn[:, :, None] * y,
            -sn[:, :, None] * x + cs[:, :, None] * y)
    # normalized sample coordinates (the y axis flips back to image rows)
    return bilinear_sample(img, x * (max(w, h) / float(w)), -y * (max(w, h) / float(h)))


def pose2d_cam_from(z, s, coin, cam, p=POSE_P, in_size=None, out_size=None):
    """The 2D pose applied to camera matrices ``cam`` ``[B, 3, 3]`` (or one
    ``[3, 3]``) instead of pixels, from the raw draws of ``pose2d_from``:
    the focal block scaled by ``exp(s * p3 + p4)``, the principal point
    shifted by ``tx * f_x`` and ``-ty * f_y`` and mirrored where ``coin <
    p5``. With both ``in_size`` and ``out_size``, ``cam`` is normalized
    (the principal point in [0, 1]): it is scaled up by ``in_size``, back
    down by ``out_size``, and mirrored to ``1 - cx``; else mirrored to
    ``out_size - cx`` (``out_size`` defaulting to ``in_size``, then 1)."""
    single = cam.ndim == 2
    if single:
        cam = cam[None]
    b = cam.shape[0]
    p = _abs_p(p, cam.device)
    z = z * p[:3]
    f = torch.exp(s * p[3] + p[4])  # [b, 1]
    flip = (coin < p[5])[:, 0]
    tx, ty = z[:, 0:1], z[:, 1:2]

    normalized = bool(in_size) and bool(out_size)
    wi = in_size or 1
    wo = out_size or in_size or 1
    cam_px = cam
    if normalized:
        cam_px = cam * torch.tensor([[wi], [wi], [1.0]], device=cam.device)[None]
    one = torch.ones_like(f)
    scale = torch.cat([f, f, one] * 2 + [one] * 3, 1).reshape(b, 3, 3)
    shift = torch.zeros(b, 3, 3, device=cam.device)
    shift[:, 0, 2] = (tx * cam_px[:, 0, 0:1])[:, 0]
    shift[:, 1, 2] = (-ty * cam_px[:, 1, 1:2])[:, 0]
    out = cam_px * scale + shift
    if normalized:
        out = out / torch.tensor([[wo], [wo], [1.0]], device=cam.device)[None]
        mirror = 1 - out[:, 0, 2]
    else:
        mirror = wo - out[:, 0, 2]
    out = out.clone()
    out[:, 0, 2] = torch.where(flip, mirror, out[:, 0, 2])
    return out[0] if single else out


def random_pose2d_cam(generator: torch.Generator, cam, p=POSE_P, in_size=None,
                      out_size=None):
    """``pose2d_cam_from`` with its draws (``z`` N(0, 1) ``[B, 3]``, ``s``
    N(0, 1) ``[B, 1]``, ``coin`` U(0, 1) ``[B, 1]``) taken from
    ``generator``, on its device."""
    b = 1 if cam.ndim == 2 else cam.shape[0]
    dev = generator.device
    z = torch.randn(b, 3, generator=generator, device=dev)
    s = torch.randn(b, 1, generator=generator, device=dev)
    coin = torch.rand(b, 1, generator=generator, device=dev)
    return pose2d_cam_from(z, s, coin, cam, p, in_size, out_size)


@dataclass
class AugDraws:
    """The raw draws of one ``ada_augment`` call on a batch of B."""

    pose_z: torch.Tensor      # N(0, 1) [B, 3]
    pose_s: torch.Tensor      # N(0, 1) [B, 1]
    pose_coin: torch.Tensor   # U(0, 1) [B, 1]
    color_z01: torch.Tensor   # N(0, 1) [B, 2]
    color_coin: torch.Tensor  # U(0, 1) [B, 1]
    color_z34: torch.Tensor   # N(0, 1) [B, 2]
    keep: torch.Tensor        # U(0, 1) [B]


def aug_draws(generator: torch.Generator, batch: int) -> AugDraws:
    """Draw an ``AugDraws`` on the generator's device."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    return AugDraws(normal(batch, 3), normal(batch, 1), uniform(batch, 1),
                    normal(batch, 2), uniform(batch, 1), normal(batch, 2), uniform(batch))


def ada_augment(img, p, draws: AugDraws, color_p=COLOR_P, pose_p=POSE_P):
    """Geometric then color augmentation of ``img`` ``[B, 3, H, W]``, kept
    per sample where ``draws.keep < p`` (``p`` a float or a 0-d tensor)."""
    aug = pose2d_from(draws.pose_z, draws.pose_s, draws.pose_coin, img, pose_p)
    aug = apply_color(aug, color_matrix_from(draws.color_z01, draws.color_coin,
                                             draws.color_z34, color_p))
    keep = (draws.keep < p)[:, None, None, None]
    return torch.where(keep, aug.to(img.dtype), img)
