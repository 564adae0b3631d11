"""GAR training in plain PyTorch, for the benchmark's check: the GAR
reference ``train.py``'s step (a fork of rosinality's stylegan2-pytorch) at
its defaults, from given weights, reals and draws.

One step, in the trainer's order:

1. D step: fakes of the D draws (mapping, style mixing, the posed mesh's
   normal pyramid, synthesis) outside the gradient, then the logistic loss
   ``softplus(-D(real)).mean() + softplus(D(fake)).mean()`` (reals and fakes
   in two forwards, so two sets of stddev groups), an Adam update of D;
2. lazy R1 every ``d_reg_every`` steps: ``E|grad_x D(x)|^2`` on the reals
   by ``autograd.grad(create_graph=True)``, a second update of D with the
   loss ``r1 / 2 * R1 * d_reg_every``;
3. G step: the non-saturating loss ``softplus(-D(G(...))).mean()`` against
   D after 1-2, an Adam update of G;
4. lazy path length every ``g_reg_every`` steps on the first ``batch //
   path_batch_shrink`` rows of the G step's meshes: the image's product
   with the probe over ``sqrt(H W)``, its gradients with respect to W+ and
   to every level of the (detached) normal pyramid, each input's per-sample
   norm ``sqrt(max(|g|^2, 1e-24))`` summed over the inputs; the running
   mean ``mean + 0.01 (pl.mean() - mean)``, the penalty ``((pl - mean')^2)
   .mean()``, a second update of G with ``path_regularize * g_reg_every``
   times it;
5. the EMA of G, ``ema * decay + g * (1 - decay)``, ``decay = 0.5 ** (32 /
   (1000 ema_halflife_kimg))``.

Adam: ``lr * ratio``, ``betas (0, 0.99 ** ratio)``, eps 1e-8 after the
bias-corrected square root, ``ratio = every / (every + 1)`` of each model's
regularizer. Departures from the published StyleGAN2 (noted in the GAR
reference too): the path length is over W+ and the normal pyramid, each
input's norm taken over all its elements (StyleGAN2's is over W's last axis,
averaged over the layers); the EMA's 32 is the reference's constant whatever
the batch. The faults of the control: ``r1=False`` leaves R1 out,
``path_maps=False`` takes the path length over W+ alone.

``steps`` runs the trainer's steps and records, for the steps asked for,
each model's last update: its gradient and the values of G, D and the path
mean it was taken at; ``gradient`` takes one update's gradient at given
values, so that the check can hold a recorded gradient against the
reference's at the very parameters it was taken at (Adam's first updates
move an element by about ``lr`` whatever its gradient's size, so two runs'
parameters part by up to ``2 lr`` where a gradient element is rounding).

Draws are a plain dict a step: ``{d,g,p}_z1``, ``_z2`` ``[B, D]``, ``_mix``
(0-d bool: mix z2 in), ``_inject`` (0-d int), ``_noise`` (per-layer
``[B, 1, r, r]``); ``d_face``, ``g_face`` ``[B, D_face]``; ``d_pose``,
``g_pose`` ``[B, 7]``; ``p_probe`` ``[B_path, 3, size, size]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gar_bench.reference import disc, gar, geometry, lowp, raster
from gar_bench.reference.lowp import Precision


class _Round(torch.autograd.Function):
    """A rounding whose backward is the same rounding of the cotangent, to
    any order (R1 and the path length differentiate the backward)."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return fn(t.detach())

    @staticmethod
    def backward(ctx, g):
        return _Round.apply(g, ctx.fn), None


_BELOW = {"float32": lowp._tf32, "tf32": lowp._bf16, "bfloat16": lowp._fp8}


def below(cfg: dict) -> Precision:
    """The control's roundings: each part one step below the precision
    ``cfg`` states (``lowp.BELOW``), differentiable to any order. D's
    convolutions take the synthesis's, its linears the mapping's."""
    p = cfg["precision"]

    def rnd(part):
        fn = _BELOW[p[part]]
        return lambda t: _Round.apply(t, fn)
    return Precision(rnd("geometry"), rnd("mapping"), rnd("synthesis"))


def ema_decay(job: dict) -> float:
    return 0.5 ** (32 / (job["ema_halflife_kimg"] * 1000))


def pyramid(face, tri, x, pose, cfg, prec: Precision):
    """The normal maps ``[B, s, s, 3]`` (4 .. size) of the prior samples
    ``x`` in the poses ``pose``, outside the gradient."""
    with torch.no_grad():
        v = geometry.euler_pose(geometry.morph(x, face["basis"], face["mean"], prec.geo),
                                pose, prec.geo)
        n = geometry.normals(v, tri)
        return [raster.interpolate(v, n, tri, raster.winners(v, tri, s), s)
                for s in gar.levels(cfg["size"])]


def latents(P, d: dict, part: str, cfg, prec: Precision):
    """W+ ``[B, n_latent, D]``: layers below the inject index take z1's W,
    the rest that of z2 where the coin mixes, else z1's."""
    z1 = d[f"{part}_z1"]
    w1 = gar.mapping(P, z1, cfg, prec.map)
    w2 = gar.mapping(P, torch.where(d[f"{part}_mix"], d[f"{part}_z2"], z1), cfg, prec.map)
    layer = torch.arange(gar.n_latent(cfg["size"]), device=z1.device)[None, :, None]
    return torch.where(layer < d[f"{part}_inject"], w1[:, None, :], w2[:, None, :])


def r1_penalty(disc_fn, real):
    """``E|grad_x D(x)|^2`` over the reals, differentiable in D."""
    x = real.detach().clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    return gx.pow(2).reshape(gx.shape[0], -1).sum(1).mean()


def path_lengths(synth_fn, lat, maps, probe, with_maps: bool = True):
    """Path lengths ``[B]`` of ``synth_fn(lat, maps)``: the gradients of
    ``sum(img * probe / sqrt(H W))`` with respect to ``lat`` and (with
    ``with_maps``) each map, each one's per-sample norm ``sqrt(max(|g|^2,
    1e-24))``, summed. Differentiable in the synthesis's weights."""
    img = synth_fn(lat, maps)
    probe = probe / math.sqrt(img.shape[2] * img.shape[3])
    inputs = [lat] + (list(maps) if with_maps else [])
    grads = torch.autograd.grad((img * probe).sum(), inputs, create_graph=True)
    b = img.shape[0]
    return sum(torch.sqrt(torch.clamp(g.pow(2).reshape(b, -1).sum(1), min=1e-24))
               for g in grads)


class _Adam:
    """Adam over a dict of leaves with zero moments and step 0."""

    def __init__(self, params: dict, lr: float, every: int):
        ratio = every / (every + 1)
        self.lr, self.b2 = lr * ratio, 0.99 ** ratio
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc2 = math.sqrt(1 - self.b2 ** self.t)
        for k, g in grads.items():
            self.m[k] = g.clone()  # beta1 = 0
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            params[k] -= self.lr * self.m[k] / (torch.sqrt(self.v[k]) / bc2 + 1e-8)


def _grads(loss, params: dict) -> dict:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g) for k, g in zip(keys, gs)}


def _leaves(P: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}


# the updates of a step, in order, and the model each updates
UPDATES = {"d": "d", "r1": "d", "g": "g", "path": "g"}


def last_updates(i: int, job: dict) -> dict:
    """The kind of each model's last update in step ``i``."""
    return {"d": "r1" if i % job["d_reg_every"] == 0 else "d",
            "g": "path" if i % job["g_reg_every"] == 0 else "g"}


class _Step:
    """The losses of step ``i``'s updates at given leaves ``G``, ``D``."""

    def __init__(self, real, d, face, tri, cfg, job, prec: Precision, path_maps: bool = True):
        self.real, self.d, self.cfg, self.job, self.prec = real, d, cfg, job, prec
        self.path_maps = path_maps
        self.maps_d = pyramid(face, tri, d["d_face"], d["d_pose"], cfg, prec)
        self.maps_g = pyramid(face, tri, d["g_face"], d["g_pose"], cfg, prec)

    def synth(self, G, part, maps, noise, lat=None):
        lat = latents(G, self.d, part, self.cfg, self.prec) if lat is None else lat
        return gar.synthesis(G, lat, maps, noise, self.cfg, self.prec.syn, self.prec.map)

    def disc(self, D, x):
        return disc.forward(D, x, self.cfg, self.prec.syn, self.prec.map)

    def loss(self, kind: str, G, D, mean_pl):
        """-> (the loss of update ``kind``, the path mean after it)."""
        d, job = self.d, self.job
        if kind == "d":
            with torch.no_grad():
                fake = self.synth(G, "d", self.maps_d, d["d_noise"])
            return (F.softplus(-self.disc(D, self.real)).mean()
                    + F.softplus(self.disc(D, fake)).mean()), mean_pl
        if kind == "r1":
            pen = r1_penalty(lambda x: self.disc(D, x), self.real)
            return job["r1"] / 2 * pen * job["d_reg_every"], mean_pl
        if kind == "g":
            img = self.synth(G, "g", self.maps_g, d["g_noise"])
            return F.softplus(-self.disc(D, img)).mean(), mean_pl
        pb = job["batch"] // job["path_batch_shrink"]
        lat = latents(G, d, "p", self.cfg, self.prec)
        maps = [m[:pb].clone().requires_grad_(True) for m in self.maps_g]
        pl = path_lengths(lambda lt, ms: self.synth(G, "p", ms, d["p_noise"], lt), lat, maps,
                          d["p_probe"], self.path_maps)
        path_mean = mean_pl + 0.01 * (pl.mean() - mean_pl)
        pen = (pl - path_mean).pow(2).mean()
        return job["path_regularize"] * job["g_reg_every"] * pen, path_mean.detach()


def gradient(kind: str, PG, PD, mean_pl: float, real, d, face, tri, cfg, job,
             prec: Precision = Precision()) -> dict:
    """The gradient of update ``kind`` of a step on ``real`` and ``d``, at G's
    ``PG`` and D's ``PD`` and the path mean ``mean_pl`` before it, by leaf
    of the model it updates."""
    G, D = _leaves(PG), _leaves(PD)
    step = _Step(real, d, face, tri, cfg, job, prec)
    loss, _ = step.loss(kind, G, D, torch.tensor(float(mean_pl), device=real.device))
    return _grads(loss, G if UPDATES[kind] == "g" else D)


def steps(PG, PD, reals, draws, face, tri, cfg, job, n: int, prec: Precision = Precision(),
          r1: bool = True, path_maps: bool = True, keep=(0, 1)) -> dict:
    """``n`` steps from G's ``PG`` and D's ``PD`` (zero moments, path mean 0)
    on ``reals[i]`` and ``draws[i]`` -> ``updates``: for each step in
    ``keep``, each model's last update in it, ``{"g": ..., "d": ...}``, each
    ``{"grad", "G", "D", "mean_path_length"}`` (its gradient, and G's, D's
    and the path mean's values it was taken at); ``mean_path_length``: the
    running mean after each step; ``params``: ``{"g", "d", "ema"}`` after
    the last step."""
    G, D = _leaves(PG), _leaves(PD)
    ema = {k: v.detach().clone() for k, v in PG.items()}
    opt = {"g": _Adam(G, job["lr"], job["g_reg_every"]),
           "d": _Adam(D, job["lr"], job["d_reg_every"])}
    mean_pl = torch.zeros((), device=reals[0].device)
    decay = ema_decay(job)
    out = {"updates": [], "mean_path_length": []}
    for i in range(n):
        step = _Step(reals[i], draws[i], face, tri, cfg, job, prec, path_maps)
        last = {}
        for kind in ("d", "r1", "g", "path"):
            if ((kind == "r1" and (not r1 or i % job["d_reg_every"]))
                    or (kind == "path" and i % job["g_reg_every"])):
                continue
            model = G if UPDATES[kind] == "g" else D
            loss, new_mean = step.loss(kind, G, D, mean_pl)
            grads = _grads(loss, model)
            if i in keep:
                last[UPDATES[kind]] = {
                    "grad": grads, "G": {k: v.detach().clone() for k, v in G.items()},
                    "D": {k: v.detach().clone() for k, v in D.items()},
                    "mean_path_length": float(mean_pl)}
            opt[UPDATES[kind]].step(model, grads)
            mean_pl = new_mean
        with torch.no_grad():
            for k in ema:
                ema[k] = ema[k] * decay + G[k] * (1 - decay)
        if i in keep:
            out["updates"].append(last)
        out["mean_path_length"].append(float(mean_pl))
    out["params"] = {"g": {k: v.detach() for k, v in G.items()},
                     "d": {k: v.detach() for k, v in D.items()}, "ema": ema}
    return out
