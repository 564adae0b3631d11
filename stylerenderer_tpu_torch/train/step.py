"""One adversarial training step (counterpart of
``stylerenderer_tpu/train/step.py::make_train_step``), in the same order:

1. D step (logistic loss) on fresh fakes from a freshly sampled, posed
   3DMM mesh, outside the gradient;
2. the ADA controller: accumulate ``sign(real_pred)`` and move the
   augmentation probability toward ``ada_target`` every ``ada_every``
   reals;
3. lazy R1 on the (unaugmented) reals every ``d_reg_every`` steps, a second
   Adam update of D;
4. G step (non-saturating loss) against D's parameters after R1, plus the
   supervisor heads' terms when ``heads`` are given (``supervisors/hub.py::
   make_extra_heads``): ``sfs`` 0.01 x smooth L1 between the masked
   normals of the fake image and the masked rasterized normal map,
   ``feature`` 0.001 x the MSE between the two halves' embeddings, ``lmk``
   1e-5 x smooth L1 between interleaved pairs' landmarks;
5. lazy path-length regularization every ``g_reg_every`` steps over W and
   the detached normal-map pyramid, a second Adam update of G;
6. the EMA of G;
7. the finite screen: when a metric or an updated parameter is not finite,
   G, D, the EMA, both optimizers, the path mean and ADA keep their old
   values and ``nonfinite_count`` goes up.

Every random draw of a step is in a ``StepDraws`` (``sample_draws`` takes
them from the state's ``torch.Generator``), so ``train_step(state, real,
draws, ...)`` is deterministic. The heads pair the G step's samples as the
reference does (``train.py:294-309``): with ``feat``, G's styles are drawn
for the first half and repeated for the second, and the shape part of the
3DMM sample is copied across the halves (``sample_draws``); with ``lmk``,
the odd samples take the posed geometry of the even ones
(``pair_geometry``) and G's fake skips ADA. Without heads the draws and
the step are those of the plain trainer. Each update takes its gradients with
``torch.autograd.grad`` with respect to its own model's parameters only.
Reading the finite flag is the step's one host synchronisation; it keeps
``state.step``, which schedules the regularizers, on the host.

The rasterizer is never differentiated: the meshes are made under
``no_grad`` and the path step's pyramid is detached, as the JAX step's
``stop_gradient``s do (its backward is first order only).

Across ranks (``mesh`` from ``parallel/mesh.py::make_mesh``, one process
per card) a world-W step computes the step of the global batch ``B``,
as the JAX step jitted over a ``Mesh('data')`` does:

- ``real`` holds the rank's rows ``[r B/W, (r+1) B/W)`` of the global
  batch (``Mesh.rows``); ``draws`` are the global draws, the same on every
  rank (``sample_draws(..., cfg.batch)`` from the replicated generator,
  with the ``feat`` half-copy applied to the global batch), and the step
  takes the rank's rows of them. The path batch is the global first
  ``path_batch_size(cfg, B)`` rows, split the same way. Every rank poses
  the global batch's meshes (the ``lmk`` pairing is the global batch's)
  and takes its rows: its G rows and its path rows, which may lie outside
  its G rows. Posed at the global batch's size, the vertices round as on
  one process, so no pixel of a rank's pyramid flips.
- Gathered with gradient (``Mesh.gather_rows``), so that every loss and
  metric is the global batch's and is equal on every rank: D's logits on
  the reals and fakes, R1's per-sample squared norms, G's logits, the
  heads' outputs (``sfs`` maps, ``feat`` embeddings, ``lmk`` landmarks)
  and the path lengths, whose mean stays inside the penalty's gradient.
  D's minibatch-stddev groups are taken over the global batch
  (``Discriminator.forward(x, mesh)``). ADA's sign sum and count are
  those of the gathered logits.
- Each of the four updates averages its gradients over the ranks
  (``Mesh.average_gradients``) between ``_grads`` and ``_adam_step``.
- The finite screen's flag is the minimum over the ranks, so that every
  rank keeps or restores its state together.

Parameters stay equal on every rank because every rank applies the same
averaged gradients to the same values. With ``mesh=None`` (or world 1
without a group) every collective is the identity.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from stylerenderer_tpu_torch.face3d.augment import AugDraws, ada_augment, aug_draws
from stylerenderer_tpu_torch.face3d.geometry import apply_pose3D, mesh_point_normal, pose3D_draws
from stylerenderer_tpu_torch.models.generator import _mix_styles, make_noise
from stylerenderer_tpu_torch.parallel.mesh import Mesh
from stylerenderer_tpu_torch.train import losses
from stylerenderer_tpu_torch.train.state import TrainState
from stylerenderer_tpu_torch.utils.config import TrainConfig
from stylerenderer_tpu_torch.utils.logging import trace_ctx


@dataclass
class StyleDraws:
    """Two latents, one mixing coin for the batch and the inject index."""

    z1: torch.Tensor  # [B, latent]
    z2: torch.Tensor  # [B, latent]
    mix: torch.Tensor  # 0-d bool: mix z2 in (else both styles are z1)
    inject: torch.Tensor  # 0-d int64 in [1, n_latent - 1]

    def styles(self):
        return [self.z1, torch.where(self.mix, self.z2, self.z1)]


@dataclass
class StepDraws:
    """Every random draw of one step: D's and G's styles, meshes (prior
    samples ``*_face`` ``[B, D]`` and poses ``*_pose`` ``[B, 7]``) and
    per-layer noise; the path step's styles, noise and image-space probe
    (N(0, 1), ``[path_batch, 3, size, size]``); the augmentations' draws
    when ``cfg.augment``."""

    d_styles: StyleDraws
    d_face: torch.Tensor
    d_pose: torch.Tensor
    d_noise: list
    g_styles: StyleDraws
    g_face: torch.Tensor
    g_pose: torch.Tensor
    g_noise: list
    p_styles: StyleDraws
    p_noise: list
    p_probe: torch.Tensor
    d_aug_real: AugDraws | None = None
    d_aug_fake: AugDraws | None = None
    g_aug: AugDraws | None = None


def path_batch_size(cfg: TrainConfig, batch: int) -> int:
    return max(1, batch // cfg.path_batch_shrink)


def _style_draws(gen: torch.Generator, batch: int, cfg: TrainConfig, n_latent: int):
    dev = gen.device
    z1 = torch.randn(batch, cfg.latent, generator=gen, device=dev)
    z2 = torch.randn(batch, cfg.latent, generator=gen, device=dev)
    mix = torch.rand((), generator=gen, device=dev) < cfg.mixing
    # the reference's randint(1, n_latent - 1) includes n_latent - 1
    inject = torch.randint(1, max(n_latent, 2), (), generator=gen, device=dev)
    return StyleDraws(z1, z2, mix, inject)


def _halves(batch: int):
    """(half, res): the first half ``(batch + 1) // 2`` and the rest."""
    half = (batch + 1) // 2
    return half, batch - half


def sample_draws(gen: torch.Generator, cfg: TrainConfig, face, batch: int,
                 n_latent: int, heads=()) -> StepDraws:
    """Draw a ``StepDraws`` for a real batch of ``batch`` on ``gen``'s device;
    with ``"feat"`` in ``heads``, G's draws are paired across the halves."""
    dev = gen.device
    pb = path_batch_size(cfg, batch)

    def mesh():
        return face.random_input(batch, gen).to(dev), pose3D_draws(gen, batch)

    d_styles = _style_draws(gen, batch, cfg, n_latent)
    d_face, d_pose = mesh()
    d_noise = make_noise(cfg.size, batch, gen, dev)
    if "feat" in heads:
        half, res = _halves(batch)
        g_styles = _style_draws(gen, half, cfg, n_latent)
        g_styles.z1 = torch.cat([g_styles.z1, g_styles.z1[:res]])
        g_styles.z2 = torch.cat([g_styles.z2, g_styles.z2[:res]])
        g_face, g_pose = mesh()
        dim0 = face.dim[0]
        g_face[half:, :dim0] = g_face[:res, :dim0]
    else:
        g_styles = _style_draws(gen, batch, cfg, n_latent)
        g_face, g_pose = mesh()
    g_noise = make_noise(cfg.size, batch, gen, dev)
    p_styles = _style_draws(gen, pb, cfg, n_latent)
    p_noise = make_noise(cfg.size, pb, gen, dev)
    p_probe = torch.randn(pb, 3, cfg.size, cfg.size, generator=gen, device=dev)
    augs = [aug_draws(gen, batch) for _ in range(3)] if cfg.augment else [None] * 3
    return StepDraws(d_styles, d_face, d_pose, d_noise, g_styles, g_face, g_pose, g_noise,
                     p_styles, p_noise, p_probe, *augs)


@torch.no_grad()
def posed_mesh(face, tri, face_x, pose):
    """(vertices, normals, tri) of the prior samples ``face_x`` in the poses
    ``pose``, outside the gradient."""
    vert = apply_pose3D(face(face_x), pose)
    return vert, mesh_point_normal(vert, tri), tri


def pair_geometry(t: torch.Tensor) -> torch.Tensor:
    """The ``lmk`` pairing: sample ``2i + 1`` takes sample ``2i``'s value."""
    t = t.clone()
    t[1::2] = t[: 2 * (t.shape[0] // 2):2]
    return t


def _style_rows(s: StyleDraws, rows: slice) -> StyleDraws:
    return StyleDraws(s.z1[rows], s.z2[rows], s.mix, s.inject)


def _aug_rows(a: AugDraws | None, rows: slice) -> AugDraws | None:
    if a is None:
        return None
    return AugDraws(*(getattr(a, f.name)[rows] for f in dataclasses.fields(a)))


def shard_draws(draws: StepDraws, rows: slice, path_rows: slice) -> StepDraws:
    """A rank's rows of the global ``draws``: ``rows`` of the batch's,
    ``path_rows`` of the path batch's; the 0-d mixing coins and inject
    indices are shared."""
    return StepDraws(
        _style_rows(draws.d_styles, rows), draws.d_face[rows], draws.d_pose[rows],
        [n[rows] for n in draws.d_noise],
        _style_rows(draws.g_styles, rows), draws.g_face[rows], draws.g_pose[rows],
        [n[rows] for n in draws.g_noise],
        _style_rows(draws.p_styles, path_rows), [n[path_rows] for n in draws.p_noise],
        draws.p_probe[path_rows],
        *(_aug_rows(a, rows) for a in (draws.d_aug_real, draws.d_aug_fake, draws.g_aug)))


def _smooth_l1(a, b):
    return F.smooth_l1_loss(a, b, beta=1.0)


def _identity(t):
    return t


def head_losses(heads: dict, fimg, norms, batch: int, gather=_identity) -> dict:
    """The heads' terms ``{metric: (weight, value)}`` on G's images
    ``fimg`` and normal maps ``norms``, in the JAX step's order. Each
    head's output (and ``sfs``'s target) goes through ``gather`` first,
    which across ranks gives the global batch of ``batch`` rows."""
    half, res = _halves(batch)
    fimg = fimg.float()
    out = {}
    if "sfs" in heads:
        nm = norms[-1]
        mask = (torch.sum(nm * nm, -1, keepdim=True) > 1e-3).to(nm.dtype)
        out["sfs"] = 0.01, _smooth_l1(gather(mask * heads["sfs"](fimg)), gather(mask * nm))
    if "feat" in heads:
        feat = gather(heads["feat"](fimg))
        out["feature"] = 0.001, torch.mean((feat[:res] - feat[half:]) ** 2)
    if "lmk" in heads:
        lmk = gather(heads["lmk"](fimg))
        out["lmk"] = 1e-5, _smooth_l1(lmk[: res * 2:2], lmk[1::2])
    return out


def _grads(loss, params):
    return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)


def _adam_step(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def _guarded(state: TrainState):
    """The tensors the finite screen restores: every parameter of G and D
    and both optimizers' moments (on the device) and step counts (on the
    host)."""
    dev, host = list(state.g.parameters()) + list(state.d.parameters()), []
    for opt in (state.g_optim, state.d_optim):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state[p]
                dev += [st["exp_avg"], st["exp_avg_sq"]]
                host.append(st["step"])
    return dev, host


def _take_backup(state: TrainState):
    dev, host = _guarded(state)
    if state.backup is None:
        state.backup = [t.detach().clone() for t in dev]
    else:
        torch._foreach_copy_(state.backup, [t.detach() for t in dev])
    return [float(t) for t in host]


def _restore_backup(state: TrainState, host_steps) -> None:
    dev, host = _guarded(state)
    with torch.no_grad():
        torch._foreach_copy_(dev, state.backup)
        for t, v in zip(host, host_steps):
            t.fill_(v)


def all_finite(values, tensors, mesh: Mesh | None = None) -> bool:
    """Whether every 0-d value and every element of ``tensors`` is finite
    (max-abs norms, one host synchronisation); with ``mesh``, on every
    rank (the minimum of the ranks' flags)."""
    flags = [v.detach().float().reshape(()) for v in values]
    flags += [n.float() for n in torch._foreach_norm([t.detach() for t in tensors],
                                                     float("inf"))]
    ok = torch.isfinite(torch.stack(flags)).all()
    if mesh is not None:
        ok = mesh.all_reduce_(ok.float(), op=dist.ReduceOp.MIN) > 0
    return bool(ok)


@torch.no_grad()
def ema_update(ema, params, decay: float) -> None:
    """``ema = ema * decay + params * (1 - decay)``, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - decay)


def ada_update(cfg: TrainConfig, p, signs, count, real_pred):
    """The ADA controller: -> (p, signs, count) after this batch's
    ``real_pred``. Every ``ada_every`` reals ``p`` moves by
    ``sign(r_t - target) * target / ada_length * count`` (clipped to
    [0, 1]) and the statistics reset."""
    signs = signs + torch.sign(real_pred).sum()
    count = count + real_pred.shape[0]
    fire = count > cfg.ada_every - 1
    r_t = signs / count
    sgn = torch.where(r_t > cfg.ada_target, 1.0, -1.0)
    moved = torch.clamp(p + sgn * (cfg.ada_target / cfg.ada_length) * count, 0.0, 1.0)
    zero = torch.zeros_like(signs)
    return (torch.where(fire, moved, p), torch.where(fire, zero, signs),
            torch.where(fire, zero, count))


def train_step(state: TrainState, real: torch.Tensor, draws: StepDraws, cfg: TrainConfig,
               face, tri, heads: dict | None = None, mesh: Mesh | None = None) -> dict:
    """One step on the real batch ``real`` ``[B, 3, size, size]`` in [-1, 1];
    updates ``state`` in place and returns the metrics (0-d tensors on the
    device, ``nonfinite_steps`` an int). ``heads``: the frozen supervisors
    (``make_extra_heads``), whose ``draws`` come from ``sample_draws(...,
    heads=heads)``. With ``mesh``, ``real`` is the rank's rows of the
    global batch, ``draws`` the global draws, and the step and its metrics
    are the global batch's (module docstring)."""
    heads = heads or {}
    mesh = Mesh() if mesh is None else mesh
    g, d = state.g, state.d
    g_params, d_params = list(g.parameters()), list(d.parameters())
    batch = real.shape[0] * mesh.world
    rows, path_rows = mesh.rows(batch), mesh.rows(path_batch_size(cfg, batch))
    local = shard_draws(draws, rows, path_rows)
    gather = mesh.gather_rows
    with trace_ctx("train.backup"):
        host_steps = _take_backup(state)
    metrics = {}
    zero = torch.zeros((), device=real.device)

    def disc(img):
        return d(img, mesh=mesh)

    def update(opt, params, loss):
        _adam_step(opt, params, mesh.average_gradients(_grads(loss, params)))

    # ---- D step ----
    with trace_ctx("train.d"):
        # every mesh is posed for the whole global batch, as on one process (a
        # smaller batch can round the vertices otherwise), and cut to the rows
        d_vert, d_norm, _ = posed_mesh(face, tri, draws.d_face, draws.d_pose)
        with torch.no_grad():
            fake = g(local.d_styles.styles(), (d_vert[rows], d_norm[rows], tri),
                     inject_index=local.d_styles.inject, noise=local.d_noise)[0]
        real_aug, fake_d = real, fake
        if cfg.augment:
            real_aug = ada_augment(real, state.ada_p, local.d_aug_real)
            fake_d = ada_augment(fake, state.ada_p, local.d_aug_fake)
        real_pred = gather(disc(real_aug))
        fake_pred = gather(disc(fake_d))
        d_loss = losses.d_logistic_loss(real_pred, fake_pred)
        update(state.d_optim, d_params, d_loss)
        real_pred = real_pred.detach()
        metrics["d"] = d_loss.detach()
        metrics["real_score"] = real_pred.mean()
        metrics["fake_score"] = fake_pred.detach().mean()

    # ---- ADA controller ----
    ada_p, ada_signs, ada_count = state.ada_p, state.ada_signs, state.ada_count
    if cfg.augment and cfg.augment_p <= 0:
        with trace_ctx("train.ada"):
            metrics["r_t"] = torch.where(ada_count > 0, ada_signs / ada_count, zero)
            ada_p, ada_signs, ada_count = ada_update(cfg, ada_p, ada_signs, ada_count,
                                                     real_pred)
    else:
        metrics["r_t"] = zero
    metrics["ada_p"] = ada_p

    # ---- lazy R1 ----
    metrics["r1"] = zero
    if state.step % cfg.d_reg_every == 0:
        with trace_ctx("train.r1"):
            r1 = losses.r1_penalty(disc, real, gather)
            update(state.d_optim, d_params, cfg.r1 / 2.0 * r1 * cfg.d_reg_every)
            metrics["r1"] = r1.detach()

    # ---- G step ----
    with trace_ctx("train.g"):
        vert_all, norm_all, _ = posed_mesh(face, tri, draws.g_face, draws.g_pose)
        if "lmk" in heads:
            vert_all, norm_all = pair_geometry(vert_all), pair_geometry(norm_all)
        vert_g, norm_g = vert_all[rows], norm_all[rows]
        fimg, _, norms = g(local.g_styles.styles(), (vert_g, norm_g, tri),
                           inject_index=local.g_styles.inject, noise=local.g_noise,
                           return_normals="sfs" in heads)
        fimg_d = fimg
        if cfg.augment and "lmk" not in heads:
            fimg_d = ada_augment(fimg, ada_p, local.g_aug)
        g_loss = losses.g_nonsaturating_loss(gather(disc(fimg_d)))
        for name, (weight, value) in head_losses(heads, fimg, norms, batch, gather).items():
            g_loss = g_loss + weight * value
            metrics[name] = value.detach()
        update(state.g_optim, g_params, g_loss)
        metrics["g"] = g_loss.detach()

    # ---- lazy path-length regularization ----
    mean_path_length = state.mean_path_length
    metrics["path"] = metrics["path_length"] = zero
    if state.step % cfg.g_reg_every == 0:
        with trace_ctx("train.path"):
            # the path batch is the global batch's first rows
            with torch.no_grad():
                pyramid = g.normal_pyramid((vert_all[path_rows], norm_all[path_rows], tri))
            w = [g.get_latent(z) for z in local.p_styles.styles()]
            latent = _mix_styles(w, g.n_latent, local.p_styles.inject, None, None)

            def synth(lat, *maps):
                return g.synthesize(lat, list(maps), noise=local.p_noise)

            pl = gather(losses.path_lengths_multi(synth, local.p_probe, (latent, *pyramid)))
            penalty, mean_path_length = losses.path_regularize(pl, state.mean_path_length)
            update(state.g_optim, g_params, cfg.path_regularize * cfg.g_reg_every * penalty)
            metrics["path"] = penalty.detach()
            metrics["path_length"] = pl.detach().mean()
    metrics["mean_path_length"] = mean_path_length

    # ---- the finite screen, then the EMA ----
    with trace_ctx("train.finish"):
        if all_finite(metrics.values(), g_params + d_params, mesh):
            ema_update(list(state.g_ema.parameters()), g_params, cfg.ema_decay)
            state.mean_path_length = mean_path_length
            state.ada_p, state.ada_signs, state.ada_count = ada_p, ada_signs, ada_count
            state.step += 1
        else:
            _restore_backup(state, host_steps)
            state.nonfinite_count += 1
    metrics["nonfinite_steps"] = state.nonfinite_count
    return metrics


def run_step(state: TrainState, real: torch.Tensor, cfg: TrainConfig, face, tri,
             heads: dict | None = None, mesh: Mesh | None = None):
    """One training iteration as ``cli.train`` runs it: inside a
    ``train.step`` span (the state's step number in its ``args``), this
    step's draws from the state's generator (``sample_draws``), then
    ``train_step``. -> (metrics, the ``StepDraws``)."""
    with trace_ctx("train.step", args=str(state.step)):
        draws = sample_draws(state.generator, cfg, face, cfg.batch, state.g.n_latent,
                             heads or ())
        return train_step(state, real, draws, cfg, face, tri, heads, mesh), draws
