"""Training: ``cli.train``'s iteration, ``train/step.py::run_step`` (the
step's draws from the state's generator, then ``train_step``), at the GAR
reference ``train.py``'s defaults, on a bank of reals held on the card.

Set-up builds the training state from the benchmark's weights (G's as the
other cells', D's drawn alike from the seed's next stream), the EMA, the two
Adams with their lazy-regularization ratios and the step's generator, and
runs steps 0-4 through ``run_step``: R1 + path, three plain steps and a path
step, so every kind of step has loaded its engines before the window. The
window runs whole cycles of ``d_reg_every`` steps (each holds one R1 step and
``d_reg_every / g_reg_every`` path steps) until ``--seconds`` have passed,
then waits for the card. A traced run traces ``trace_cycles`` whole cycles.

End-to-end: ``step_ms``, the window over the steps completed in it, so a
cycle's mean. The check: set-up's steps against the reference
(``reference/train.py``) from the same weights, reals and draws: each
model's last update in steps 0 (R1, the path length) and 1 (the two
losses), its gradient as the optimizer got it (recorded by a hook on each
optimizer during set-up, which the window runs without) against the
reference's at the parameters it was taken at; the change of G, D and the
EMA over steps 0-4; the running path-length mean after each of them; and
the steps that the finite screen discarded (any one trained nothing). The
control: the reference one precision below, or with a fault (``no_r1``: R1
left out; ``w_only``: the path length over W+ alone), in the program's
place.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import sys
import time
from types import SimpleNamespace

import torch

from gar_bench import compare, inputs, peaks, pyramid_work, train_flops
from gar_bench.common import DTYPES, exact_float32, load_weights, program_flags, sync, wrap_layers
from gar_bench.reference import disc, gar, geometry
from gar_bench.reference import train as ref_train
from gar_bench.reference.lowp import Precision

# the end-to-end metric that a reader of what every loop provides moves here
MOVES = "step_ms"
# the steps whose updates the check compares: step 0's last updates are R1
# (D) and the path length (G), step 1's the two losses
COMPARED = (0, 1)
# the compared gradients by the update they belong to
LOSSES = ("step0.d", "step1.d", "step1.g")  # R1, logistic, non-saturating
PATH = "step0.g"
FAULTS = {"no_r1": {"r1": False}, "w_only": {"path_maps": False}}


def tiny_traffic(t: dict) -> dict:
    """The traffic of the CPU tests' tiny copy of a cell of this kind: a
    cycle of 4 steps, R1 every 4 and the path length every 2."""
    return dict(t, batch=4, real_bank=8, d_reg_every=4, g_reg_every=2)


def draw_seed(seed: int) -> int:
    """Seed of the training state's generator, which draws every step."""
    h = hashlib.sha256(f"{int(seed)}/train_draws".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def plain_draws(sd) -> dict:
    """A ``StepDraws`` as the reference's plain dict."""
    out = {}
    for part, s in (("d", sd.d_styles), ("g", sd.g_styles), ("p", sd.p_styles)):
        out.update({f"{part}_z1": s.z1, f"{part}_z2": s.z2, f"{part}_mix": s.mix,
                    f"{part}_inject": s.inject})
    out.update(d_face=sd.d_face, d_pose=sd.d_pose, d_noise=sd.d_noise, g_face=sd.g_face,
               g_pose=sd.g_pose, g_noise=sd.g_noise, p_noise=sd.p_noise, p_probe=sd.p_probe)
    return out


def _gaps(prog: dict, ref: dict, leaves) -> dict:
    return {k: (v if math.isfinite(v) else math.inf)
            for k, v in compare.norm_gaps(prog, ref, leaves).items()}


def _values(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _change(params: dict, p0: dict, parts) -> dict:
    return {f"{part}.{k}": params[part][k] - p0[part][k] for part in parts for k in p0[part]}


def big_leaf_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """The worst relative L2 gap ``|prog_k - ref_k| / |ref_k|`` over the
    leaves whose reference norm is at least the median leaf's (of the leaves
    not nought, ``compare.counted_leaves``) -> (the gap, its leaf). The
    smaller leaves (biases, noise strengths) take sums that cancel, which
    lift any rounding alike and so tell no precision from another."""
    leaves = compare.counted_leaves(ref)
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in leaves}
    med = compare.median(norms.values())
    gaps = {k: compare.rel_l2(prog[k], ref[k]) for k in leaves if norms[k] >= med}
    key = max(gaps, key=gaps.get)
    return (gaps[key] if math.isfinite(gaps[key]) else math.inf), key


def whole_gap(prog: dict, ref: dict) -> float:
    """``|prog - ref| / |ref|`` over the leaves not nought
    (``compare.counted_leaves``) taken as one vector, in float64. The large
    leaves weigh most, so one small leaf whose sums cancel (a bias of the
    normal-map ResBlocks) does not decide it."""
    leaves = compare.counted_leaves(ref)
    num = sum(float(torch.linalg.vector_norm((prog[k] - ref[k]).double())) ** 2 for k in leaves)
    den = sum(float(torch.linalg.vector_norm(ref[k].double())) ** 2 for k in leaves)
    gap = math.sqrt(num / den)
    return gap if math.isfinite(gap) else math.inf


def train_numbers(prog: dict, ref: dict, at: list, p0: dict) -> tuple[dict, dict]:
    """The training check -> (the numbers compared, the look behind them).

    ``prog`` and ``ref`` each hold ``params`` (G, D and the EMA after the
    last set-up step) and ``mean_path_length`` (after each step), ``prog``
    also ``updates`` (for each ``COMPARED`` step, each model's last update:
    its ``grad`` by leaf, and what it was taken at); ``at`` holds the
    reference's gradients of the same updates at ``prog``'s recorded values;
    ``p0`` G's and D's start. Compared: ``grad_gap``, the worst
    ``whole_gap`` of the R1, logistic and non-saturating gradients;
    ``path_grad_gap``, the path term's (its own limit: the program reads a
    seventh of the others there, and only there one precision below tells);
    ``change_gap`` and ``ema_change_gap``, the median leaf's gap of the
    norms of the change of G and D, and of the EMA, over the set-up steps
    (``compare.norm_gaps``); ``path_mean_gap``, the worst relative gap of
    the running path-length mean after a set-up step.
    Shown only: each gradient's ``big_leaf_gap`` and its worst leaf, the
    worst leaf's change and both runs' path means."""
    grads = {}
    for i, pu, ru in zip(COMPARED, prog["updates"], at):
        for part in ("g", "d"):
            big, key = big_leaf_gap(pu[part]["grad"], ru[part])
            grads[f"step{i}.{part}"] = [whole_gap(pu[part]["grad"], ru[part]), big, key]
    d_prog, d_ref = _change(prog["params"], p0, "gd"), _change(ref["params"], p0, "gd")
    change = _gaps(d_prog, d_ref, list(d_ref))
    e0 = {"ema": p0["g"]}
    ema = _gaps(_change(prog["params"], e0, ["ema"]), _change(ref["params"], e0, ["ema"]),
                [f"ema.{k}" for k in p0["g"]])
    means = [prog["mean_path_length"], ref["mean_path_length"]]
    mean_gaps = [abs(a - b) / abs(b) for a, b in zip(*means)]  # step 0 updates the mean
    out = {"grad_gap": max(grads[k][0] for k in LOSSES), "path_grad_gap": grads[PATH][0],
           "change_gap": compare.median(change.values()),
           "ema_change_gap": compare.median(ema.values()),
           "path_mean_gap": max(g if math.isfinite(g) else math.inf for g in mean_gaps)}
    look = {"grads": grads, "change_gap_worst_leaf": max(change.items(), key=lambda kv: kv[1]),
            "mean_path_length": means}
    return out, look


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        self.batch, self.cycle = traffic["batch"], traffic["d_reg_every"]
        if self.cycle % traffic["g_reg_every"] or traffic["real_bank"] % self.batch:
            raise ValueError("g_reg_every must divide d_reg_every, the batch the bank")
        self.discarded = 0

    def inputs(self):
        """The face model, G's and D's weights and the bank of reals."""
        cfg, t = self.cfg, self.traffic
        self.face, self.tri = inputs.face_model(cfg["mesh"], self.seed, self.dev)
        self.P = inputs.weights(cfg, self.seed, self.dev)
        normal = torch.randn(disc.n_params(cfg), device=self.dev,
                             generator=inputs.stream(self.seed, "weights", 1, self.dev))
        self.PD = disc.weights(cfg, normal)
        bank = inputs.targets(self.seed, t["real_bank"], cfg["size"], t["real_grid"], self.dev)
        self.reals = list(bank.split(self.batch))

    def job(self):
        """The trainer's ``TrainConfig`` for this traffic."""
        from stylerenderer_tpu_torch.utils.config import TrainConfig

        cfg, t = self.cfg, self.traffic
        return TrainConfig(
            size=cfg["size"], latent=cfg["style_dim"], n_mlp=cfg["n_mlp"],
            channel_multiplier=cfg["channel_multiplier"], batch=t["batch"], lr=t["lr"],
            r1=t["r1"], path_regularize=t["path_regularize"],
            path_batch_shrink=t["path_batch_shrink"], d_reg_every=t["d_reg_every"],
            g_reg_every=t["g_reg_every"], mixing=t["mixing"],
            ema_halflife_kimg=t["ema_halflife_kimg"], seed=draw_seed(self.seed))

    def morphable(self):
        from stylerenderer_tpu_torch.face3d import LinearMorphableModel

        m = self.cfg["mesh"]
        return LinearMorphableModel(self.face["basis"], self.face["mean"], self.face["sigma"],
                                    m["shape_dim"], m["expression_dim"])

    # -- set-up ----------------------------------------------------------
    def setup(self):
        from stylerenderer_tpu_torch.models import Discriminator, GeneratorWithMap
        from stylerenderer_tpu_torch.train import TrainState, make_optimizers, run_step

        cfg, dc = self.cfg, self.cfg["discriminator"]
        program_flags()
        t = time.perf_counter()
        self.inputs()
        sync(self.dev)
        self.phases = {"inputs": time.perf_counter() - t}
        t = time.perf_counter()
        dtype = DTYPES[cfg["precision"]["synthesis"]]
        g = GeneratorWithMap(
            cfg["size"], cfg["style_dim"], cfg["n_mlp"], n_stylemap=cfg["n_stylemap"],
            channel_multiplier=cfg["channel_multiplier"], lr_mlp=cfg["lr_mlp"], dtype=dtype,
            pyramid_mode=cfg["pyramid_mode"], fused_pyramid=cfg["fused_pyramid"],
            device=self.dev)
        load_weights(g, self.P)
        d = Discriminator(cfg["size"], dc["channel_multiplier"], tuple(cfg["blur_kernel"]),
                          dc["stddev_group"], dc["stddev_feat"], dtype=dtype, device=self.dev)
        load_weights(d, self.PD)
        self.tcfg = self.job()
        g_optim, d_optim = make_optimizers(self.tcfg, g, d)

        def scalar():
            return torch.zeros((), device=self.dev)

        self.state = TrainState(
            g=g, d=d, g_ema=copy.deepcopy(g).eval().requires_grad_(False), g_optim=g_optim,
            d_optim=d_optim, generator=torch.Generator(self.dev).manual_seed(self.tcfg.seed),
            mean_path_length=scalar(), ada_p=scalar(), ada_signs=scalar(), ada_count=scalar())
        self.model, self._run_step, self.n = self.morphable(), run_step, 0
        sync(self.dev)
        self.phases["program"] = time.perf_counter() - t
        # steps 0-4 through the window's own call, recorded for the check
        st, self.draws, last = self.state, [], {}
        self.first = {"updates": [], "mean_path_length": []}
        hooks = [opt.register_step_pre_hook(self._recorder(part, last))
                 for part, opt in (("g", st.g_optim), ("d", st.d_optim))]
        for i in range(self.traffic["warmup_steps"]):
            t = time.perf_counter()
            last.clear()
            self.draws.append(plain_draws(self._step()))
            if i in COMPARED:
                self.first["updates"].append(dict(last))
            self.first["mean_path_length"].append(float(st.mean_path_length))
            self.phases[f"step {i}"] = time.perf_counter() - t
        for h in hooks:
            h.remove()
        self.first["params"] = {part: _values(m)
                                for part, m in (("g", st.g), ("d", st.d), ("ema", st.g_ema))}
        self.discarded = st.nonfinite_count

    def _recorder(self, part: str, last: dict):
        """An optimizer pre-hook that keeps, in the compared steps, the update's
        gradient (the ``grad`` that ``train_step`` hands Adam) and the values
        of G, D and the path mean it was taken at."""
        def hook(opt, args, kwargs):
            if self.n - 1 not in COMPARED:
                return
            st = self.state
            model = st.g if part == "g" else st.d
            last[part] = {"grad": {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()},
                          "G": _values(st.g), "D": _values(st.d),
                          "mean_path_length": float(st.mean_path_length)}
        return hook

    def _step(self):
        """One timed unit: ``run_step`` on the bank's next batch -> its draws."""
        real = self.reals[self.n % len(self.reals)]
        self.n += 1
        return self._run_step(self.state, real, self.tcfg, self.model, self.tri)[1]

    # -- the window ------------------------------------------------------
    def _loop(self, seconds: float, cycles: int | None = None, kept: list | None = None):
        """The window; ``kept`` gets each step's number and draws."""
        before, steps = self.state.nonfinite_count, 0
        t0 = time.perf_counter()
        while (steps < cycles * self.cycle if cycles is not None
               else time.perf_counter() - t0 < seconds):
            for _ in range(self.cycle):
                i = self.state.step
                draws = self._step()
                if kept is not None:
                    kept.append((i, draws))
            steps += self.cycle
        sync(self.dev)
        window = time.perf_counter() - t0
        discarded = self.state.nonfinite_count - before
        self.discarded += discarded
        print(f"window: {steps} steps in {window:.3f} s, {discarded} discarded; path mean "
              f"{float(self.state.mean_path_length):.4f}", file=sys.stderr, flush=True)
        return window, steps

    def window(self, seconds: float) -> dict:
        window_s, steps = self._loop(seconds)
        self.attempted = steps
        return {"step_ms": 1e3 * window_s / steps}

    def traced(self, seconds: float):
        """``trace_cycles`` whole cycles under the profiler, with ranges around
        G's ``normal_pyramid`` and ``synthesize``."""
        from gar_bench import trace

        wrap_layers(self.state.g)
        cycles, kept = self.traffic["trace_cycles"], []
        (_, steps), tr = trace.run_traced(torch, lambda: self._loop(seconds, cycles, kept))
        self.attempted = steps
        return SimpleNamespace(
            trace=tr, units=steps, pyramid_bound_s=self.pyramid_bound_s(kept),
            flops_done=train_flops.cycle_flops(self.cfg, self.traffic) * cycles,
            peak_flops=peaks.FLOPS_PER_S[self.cfg["precision"]["synthesis"]])

    def pyramid_bound_s(self, kept: list) -> float:
        """The least time (``pyramid_work.py``) of the pyramids of the steps in
        ``kept`` (step number, ``StepDraws``): the D step's and the G step's,
        and on a path step the path batch's, the G step's first rows. The
        meshes are posed by the reference's geometry."""
        sizes = gar.levels(self.cfg["size"])
        pb = self.batch // self.traffic["path_batch_shrink"]
        basis, mean = self.face["basis"], self.face["mean"]
        total = 0.0
        with torch.no_grad(), exact_float32():
            for i, sd in kept:
                d = geometry.euler_pose(geometry.morph(sd.d_face, basis, mean), sd.d_pose)
                g = geometry.euler_pose(geometry.morph(sd.g_face, basis, mean), sd.g_pose)
                posed = [d, g] + ([g[:pb]] if i % self.traffic["g_reg_every"] == 0 else [])
                total += sum(pyramid_work.work(v, self.tri, sizes)["bound_s"] for v in posed)
        return total

    # -- the check -------------------------------------------------------
    def release(self):
        del self.state, self.model
        torch.cuda.empty_cache()

    def reference(self, prec=None, keep=COMPARED, **fault) -> dict:
        """The reference's set-up steps from the same weights, reals and draws
        (``prec``: the control's roundings; ``keep``: the steps whose updates
        it records; ``fault``: ``FAULTS``' flags)."""
        n = len(self.draws)
        reals = [self.reals[i % len(self.reals)] for i in range(n)]
        with exact_float32():
            return ref_train.steps(self.P, self.PD, reals, self.draws, self.face, self.tri,
                                   self.cfg, self.traffic, n, prec or Precision(),
                                   keep=keep, **fault)

    def gradients_at(self, updates: list) -> list:
        """The reference's gradient of each recorded update, at the values it
        was taken at: each model's last update of each ``COMPARED`` step."""
        out = []
        with exact_float32():
            for i, upd in zip(COMPARED, updates):
                kinds = ref_train.last_updates(i, self.traffic)
                out.append({part: ref_train.gradient(
                    kinds[part], u["G"], u["D"], u["mean_path_length"],
                    self.reals[i % len(self.reals)], self.draws[i], self.face, self.tri,
                    self.cfg, self.traffic) for part, u in upd.items()})
        return out

    def check(self) -> dict:
        numbers, look = train_numbers(self.first, self.reference(keep=()),
                                      self.gradients_at(self.first["updates"]),
                                      {"g": self.P, "d": self.PD})
        print(f"look {json.dumps(look)}", file=sys.stderr)
        return dict(numbers, discarded_steps=self.discarded)

    def program_draws(self) -> list[dict]:
        """The set-up steps' draws as the trainer draws them (``sample_draws``
        from the state's generator, nothing else drawing from it), without
        running the program."""
        from stylerenderer_tpu_torch.train import sample_draws

        job, model = self.job(), self.morphable()
        gen = torch.Generator(self.dev).manual_seed(job.seed)
        return [plain_draws(sample_draws(gen, job, model, job.batch, gar.n_latent(job.size)))
                for _ in range(self.traffic["warmup_steps"])]


def control_readings(client, traffic, cfg, seed, fault, batches) -> dict:
    """The control's or a fault's numbers (``control.py``): ``client`` holds
    the inputs; the draws are the trainer's own."""
    client.draws = client.program_draws()
    ref = client.reference(keep=())
    if fault is None:
        other = client.reference(prec=ref_train.below(cfg))
    elif fault in FAULTS:
        other = client.reference(**FAULTS[fault])
    else:
        raise ValueError(f"unknown fault {fault!r}: one of {sorted(FAULTS)}")
    numbers, look = train_numbers(other, ref, client.gradients_at(other["updates"]),
                                  {"g": client.P, "d": client.PD})
    return dict(numbers, discarded_steps=0, look=look)
