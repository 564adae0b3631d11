"""Render inverting in plain PyTorch, for the benchmark's check: the
projector's loss (pixel L2, the 3DMM prior, the pose term), its gradients
through the normal pyramid's interpolation, the geometry group's clip by
its global norm and Adam in two groups, step by step from a given state.

Leaves: ``w`` (w+ ``[B, n_latent, D]``), ``x`` (3DMM ``[B, D_face]``),
``rvec``, ``tvec`` ``[B, 3]``, ``log_scale`` ``[B, 1]``.
"""

from __future__ import annotations

import torch

from gar_bench.reference import gar, geometry, raster
from gar_bench.reference.lowp import Precision

LEAVES = ("w", "x", "rvec", "tvec", "log_scale")
GEO = LEAVES[1:]


def init_params(mean_w, batch: int, cfg: dict, face_dim: int):
    """The projector's start: w+ at the mean latent, zero geometry."""
    dev = mean_w.device
    w0 = mean_w[:, None, :].repeat(batch, gar.n_latent(cfg["size"]), 1)
    z = dict(device=dev, dtype=torch.float32)
    return {"w": w0, "x": torch.zeros(batch, face_dim, **z),
            "rvec": torch.zeros(batch, 3, **z), "tvec": torch.zeros(batch, 3, **z),
            "log_scale": torch.zeros(batch, 1, **z)}


def render(P, p, face, tri, cfg, prec: Precision):
    vert = geometry.axis_angle_pose(
        geometry.morph(p["x"], face["basis"], face["mean"], prec.geo),
        p["rvec"], p["tvec"], p["log_scale"], prec.geo)
    norm = geometry.normals(vert, tri)
    maps = [raster.interpolate(vert, norm, tri, raster.winners(vert, tri, s), s)
            for s in gar.levels(cfg["size"])]
    noise = [torch.zeros(1, 1, 1, 1, device=vert.device)] * len(gar.noise_shapes(cfg["size"]))
    return gar.synthesis(P, p["w"], maps, noise, cfg, prec.syn, prec.map)


def loss(P, p, target, face, tri, cfg, weights: dict, prec: Precision, rows=None):
    """The projector's total loss; ``rows`` (a slice) keeps only those
    faces in every term, each term's mean over them."""
    img = render(P, p, face, tri, cfg, prec)
    if rows is not None:
        img, target = img[rows], target[rows]
        p = {k: v[rows] for k, v in p.items()}
    total = weights["w_pixel_l2"] * torch.mean((img - target) ** 2)
    total = total + weights["w_prior"] * (
        torch.sum((p["x"] / face["sigma"][None, :]) ** 2) / p["x"].shape[0])
    total = total + weights["w_pose"] * (
        torch.mean(p["rvec"] ** 2) + torch.mean(p["tvec"] ** 2) + torch.mean(p["log_scale"] ** 2))
    return total


def steps(P, params, target, face, tri, cfg, pcfg: dict, n: int,
          prec: Precision = Precision(), rows=None):
    """``n`` Adam steps from ``params`` (and zero moments) -> (losses before
    each update, the first step's gradients after the clip by leaf, the
    parameters after the last step)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = pcfg["betas"]
    lr = {k: (pcfg["lr"] if k == "w" else pcfg["lr_geom"]) for k in LEAVES}
    losses, first = [], None
    for t in range(1, n + 1):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        total = loss(P, leaves, target, face, tri, cfg, pcfg, prec, rows)
        grads = dict(zip(LEAVES, torch.autograd.grad(total, [leaves[k] for k in LEAVES])))
        losses.append(float(total.detach()))
        norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in GEO))
        if norm >= pcfg["geo_grad_clip"]:
            for k in GEO:
                grads[k] = grads[k] / norm * pcfg["geo_grad_clip"]
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in LEAVES:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                p[k] = p[k].detach() - lr[k] * mh / (torch.sqrt(vh) + pcfg["eps"])
    return losses, first, {k: v.detach() for k, v in p.items()}
