"""Render inverting: face reconstruction by inverting the GAR (counterpart
of ``stylerenderer_tpu/inversion/project.py``).

- variables: extended latents ``w+ [B, n_latent, D]``, 3DMM parameters
  ``x [B, D_face]``, rigid pose (axis-angle ``rvec``, translation
  ``tvec``, ``log_scale``);
- init: the generator's mean latent (or the Regressor's code) and zero
  geometry;
- losses: pixel L2 and L1, an optional perceptual distance, 2D landmarks
  (projected mesh landmarks against given ones), the 3DMM prior
  (``face.regulation``), pose, and a pull of w+ toward the mean latent;
- optimizer: Adam in two groups, ``lr`` for w+ and ``lr_geom`` for the
  geometry, whose gradient is first clipped by its global norm.

Images are the generator's own layout, ``[B, 3, H, W]`` in [-1, 1] (the
JAX package's are ``[B, H, W, 3]``). A step is one eager forward and
backward through the GAR: on the card the fused pyramid's winner search is
the multi-level kernel, the unfused ``downsample`` path's the single-level
one, and the vertex gradients are the rasterizer's interpolation-only
recompute. The loop never waits on the card: the loss history stays on the
device until the fit ends.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

import torch

from stylerenderer_tpu_torch.face3d.geometry import mesh_point_normal
from stylerenderer_tpu_torch.face3d.transforms import rodrigues
from stylerenderer_tpu_torch.models.generator import make_noise
from stylerenderer_tpu_torch.utils.logging import trace_ctx


@dataclass(frozen=True)
class ProjectorConfig:
    iters: int = 300
    lr: float = 0.05
    lr_geom: float = 0.01
    w_pixel_l2: float = 1.0
    w_pixel_l1: float = 0.0
    w_lpips: float = 0.8
    w_lmk: float = 1e-3
    w_prior: float = 1e-4
    w_pose: float = 1e-2
    w_reg_w: float = 0.0  # pull of w+ toward the mean latent
    noise_mode: str = "zero"  # 'zero' | 'random'
    # global-norm clip on the geometry group's gradient: sliver triangles can
    # spike the vertex gradient for one step; the clip keeps one spike from
    # derailing the Adam moments
    geo_grad_clip: float = 100.0


GEO = ("x", "rvec", "tvec", "log_scale")
# optax.adam's defaults
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
MEAN_LATENT_DRAWS = 4096


def _apply_pose(vert, rvec, tvec, log_scale):
    """Rigid pose in the row-vector convention: ``v' = s * v @ R + t``."""
    with trace_ctx("geometry.pose"):
        R = rodrigues(rvec)
        s = torch.exp(log_scale)[:, :, None]  # [B, 1, 1]
        return s * torch.einsum("bnk,bkj->bnj", vert, R) + tvec[:, None, :]


def _clip_by_global_norm(grads, max_norm: float) -> None:
    """In place, as ``optax.clip_by_global_norm``: where the global norm is
    at least ``max_norm``, ``g / norm * max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``); no host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def _torch_generator(generator_or_seed) -> torch.Generator:
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    return torch.Generator().manual_seed(int(generator_or_seed))


def make_projector(
    gen,
    face,
    tri,
    cfg: ProjectorConfig = ProjectorConfig(),
    lpips_fn: Callable | None = None,
    lmk_vidx=None,
    lmk_target_fn: Callable | None = None,
    regressor_fn: Callable | None = None,
):
    """Build ``project(generator_or_seed, target [B, 3, H, W] in [-1, 1],
    target_lmk=None)`` for the ``GeneratorWithMap`` ``gen``, which is put in
    eval mode with its parameters frozen.

    face: a ``LinearMorphableModel`` (the init needs ``face.sigma``).
    lpips_fn: ``(a, b) -> [B]`` perceptual distance.
    lmk_vidx: ``[L]`` int vertex ids of the mesh landmarks; ``target_lmk``
    is then ``[B, L, 2]`` in pixels.
    lmk_target_fn: accepted for the JAX package's signature, unused there
    too.
    regressor_fn: optional ``img -> w [B, D]`` encoder for the init.
    """
    if getattr(face, "sigma", None) is None:
        raise TypeError(f"inversion needs a LinearMorphableModel (its prior sigma), "
                        f"not {type(face).__name__}")
    if cfg.noise_mode not in ("zero", "random"):
        raise ValueError(f"noise_mode {cfg.noise_mode!r}: 'zero' or 'random'")
    gen.eval().requires_grad_(False)
    dev = gen.device
    tri = torch.as_tensor(tri, device=dev)
    lmk_idx = None if lmk_vidx is None else torch.as_tensor(lmk_vidx, device=dev).long()
    n_latent, size = gen.n_latent, gen.size

    def render(p, noise):
        vert = _apply_pose(face(p["x"]), p["rvec"], p["tvec"], p["log_scale"])
        norm = mesh_point_normal(vert, tri)
        pyramid = gen.normal_pyramid((vert, norm, tri))
        return gen.synthesize(p["w"], pyramid, noise), vert

    def loss_fn(p, target, target_lmk, noise, mean_w):
        img, vert = render(p, noise)
        losses = {}
        total = 0.0
        if cfg.w_pixel_l2:
            l2 = torch.mean((img - target) ** 2)
            losses["pixel_l2"] = l2
            total = total + cfg.w_pixel_l2 * l2
        if cfg.w_pixel_l1:
            l1 = torch.mean(torch.abs(img - target))
            losses["pixel_l1"] = l1
            total = total + cfg.w_pixel_l1 * l1
        if lpips_fn is not None and cfg.w_lpips:
            lp = torch.mean(lpips_fn(img, target))
            losses["lpips"] = lp
            total = total + cfg.w_lpips * lp
        if lmk_idx is not None and target_lmk is not None and cfg.w_lmk:
            # the mesh landmarks through the renderer's NDC -> pixel map
            lv = vert[:, lmk_idx, :]
            px = (1 + lv[..., 0]) * size / 2 - 0.5
            py = (1 - lv[..., 1]) * size / 2 - 0.5
            ll = torch.mean((torch.stack([px, py], -1) - target_lmk) ** 2)
            losses["lmk"] = ll
            total = total + cfg.w_lmk * ll
        if cfg.w_prior:
            pr = face.regulation(p["x"]) / p["x"].shape[0]
            losses["prior"] = pr
            total = total + cfg.w_prior * pr
        if cfg.w_pose:
            pp = (torch.mean(p["rvec"] ** 2) + torch.mean(p["tvec"] ** 2)
                  + torch.mean(p["log_scale"] ** 2))
            losses["pose"] = pp
            total = total + cfg.w_pose * pp
        if cfg.w_reg_w:
            rw = torch.mean((p["w"] - mean_w[None]) ** 2)
            losses["w_reg"] = rw
            total = total + cfg.w_reg_w * rw
        losses["total"] = total
        return img, vert, losses

    def project(generator_or_seed, target, target_lmk=None, *, state=None, n_steps=None,
                return_state=False, mean_latent=None):
        """One fit of ``n_steps`` (default ``cfg.iters``) Adam steps.

        generator_or_seed: a CPU ``torch.Generator`` or an int seed; the
        mean latent (over 4096 draws) and then, with ``noise_mode="random"``,
        one set of noise maps are drawn from it, and every step reuses that
        noise. ``mean_latent`` ``[1, D]`` replaces the drawn mean latent.
        ``state``: ``(params, optimizer state)``, the carry of an earlier
        call with ``return_state=True``, resumed instead of the init.
        Returns ``w_plus``, ``face_params``, ``rvec``, ``tvec``,
        ``log_scale``, ``render`` and ``vertices`` at the final parameters,
        ``loss_history`` (the total loss before each step's update),
        ``losses`` (every term at the final parameters) and, if asked,
        ``state``.
        """
        steps = cfg.iters if n_steps is None else n_steps
        if steps <= 0:
            raise ValueError(f"a fit needs at least one step, got {steps}")
        target = torch.as_tensor(target, device=dev)
        if target.ndim != 4 or tuple(target.shape[1:]) != (3, size, size):
            raise ValueError(f"target must be [B, 3, {size}, {size}] (the generator's "
                             f"size and layout), got {tuple(target.shape)}")
        if target_lmk is not None:
            target_lmk = torch.as_tensor(target_lmk, device=dev)
        B = target.shape[0]
        rng = _torch_generator(generator_or_seed)
        with torch.no_grad():
            if mean_latent is None:
                mean_w = gen.mean_latent(MEAN_LATENT_DRAWS, rng)
            else:
                mean_w = torch.as_tensor(mean_latent, device=dev)
            if cfg.noise_mode == "zero":
                noise = [torch.zeros(1, 1, 1, 1, device=dev)] * gen.num_layers
            else:
                noise = make_noise(size, B, rng, dev)
            if state is None:
                if regressor_fn is not None:
                    w0 = regressor_fn(target)[:, None, :].repeat(1, n_latent, 1)
                else:
                    w0 = mean_w[:, None, :].repeat(B, n_latent, 1)
                zeros = dict(device=dev, dtype=w0.dtype)
                params0 = {"w": w0, "x": torch.zeros(B, face.sigma.shape[0], **zeros),
                           "rvec": torch.zeros(B, 3, **zeros),
                           "tvec": torch.zeros(B, 3, **zeros),
                           "log_scale": torch.zeros(B, 1, **zeros)}
            else:
                params0, opt_state = state
        p = {k: torch.as_tensor(params0[k], device=dev).detach().clone().requires_grad_(True)
             for k in ("w",) + GEO}
        opt = torch.optim.Adam([{"params": [p["w"]], "lr": cfg.lr},
                                {"params": [p[k] for k in GEO], "lr": cfg.lr_geom}],
                               betas=BETAS, eps=ADAM_EPS)
        if state is not None:
            opt.load_state_dict(copy.deepcopy(opt_state))
        hist = []
        for _ in range(steps):
            with trace_ctx("project.forward"):
                _, _, losses = loss_fn(p, target, target_lmk, noise, mean_w)
            opt.zero_grad(set_to_none=True)
            with trace_ctx("project.backward"):
                losses["total"].backward()
            if cfg.geo_grad_clip:
                with torch.no_grad():
                    _clip_by_global_norm([p[k].grad for k in GEO], cfg.geo_grad_clip)
            opt.step()
            hist.append(losses["total"].detach())
        with torch.no_grad():
            img, vert, final = loss_fn(p, target, target_lmk, noise, mean_w)
        out = {
            "w_plus": p["w"].detach(),
            "face_params": p["x"].detach(),
            "rvec": p["rvec"].detach(),
            "tvec": p["tvec"].detach(),
            "log_scale": p["log_scale"].detach(),
            "render": img,
            "vertices": vert,
            "loss_history": torch.stack(hist),
            "losses": final,
        }
        if return_state:
            out["state"] = ({k: v.detach().clone() for k, v in p.items()},
                            copy.deepcopy(opt.state_dict()))
        return out

    return project


def fit_segmented(project, generator, target, target_lmk=None, *, iters, segments=2):
    """Run a ``make_projector`` fit as ``segments`` calls carrying
    ``(params, optimizer state)``: the same Adam trajectory as one call of
    ``iters`` steps (a ``torch.Generator`` is rewound before each call, so
    every segment draws the same mean latent and noise). Kept from the JAX
    package, whose reason, a bound on one dispatch's wall clock, does not
    arise here, for its per-segment progress hook and the CLI's
    ``--segments``."""
    if iters <= 0:
        raise ValueError(f"iters must be > 0, got {iters}")
    if segments <= 0:
        raise ValueError(f"segments must be > 0, got {segments}")
    rewind = generator.get_state() if isinstance(generator, torch.Generator) else None
    per = -(-iters // segments)
    state, hists, out, done = None, [], None, 0
    while done < iters:
        k = min(per, iters - done)
        if rewind is not None:
            generator.set_state(rewind)
        out = dict(project(generator, target, target_lmk, state=state, n_steps=k,
                           return_state=True))
        state = out.pop("state")
        hists.append(out["loss_history"])
        done += k
    out["loss_history"] = torch.cat(hists)
    return out


def make_projector_jit(
    gen,
    face,
    tri,
    cfg: ProjectorConfig = ProjectorConfig(),
    lpips=None,
    lmk_vidx=None,
    regressor=None,
):
    """``make_projector`` behind the JAX package's call shape
    ``run(g_params, generator, target, target_lmk=None, segments=1)``:
    ``g_params`` is a state dict loaded into ``gen`` (strictly) before the
    fit, or None for its own weights; ``lpips`` and ``regressor`` are
    callables. It compiles nothing: its reason in JAX, the size of a
    program with the weights captured by value, does not arise here.
    ``segments != 1`` runs ``fit_segmented``."""
    project = make_projector(gen, face, tri, cfg, lpips_fn=lpips, lmk_vidx=lmk_vidx,
                             regressor_fn=regressor)

    def run(g_params, generator, target, target_lmk=None, segments: int = 1):
        if g_params is not None:
            gen.load_state_dict(g_params, strict=True)
        if segments != 1:
            return fit_segmented(project, generator, target, target_lmk, iters=cfg.iters,
                                 segments=segments)
        return project(generator, target, target_lmk)

    return run
