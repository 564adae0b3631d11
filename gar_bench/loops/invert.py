"""Reconstruction: ``cli.project``'s fit, ``inversion/project.py::
make_projector`` then ``project``, on a batch of targets at once.

Set-up builds the projector and drives it from the seed through its first
three Adam steps, by the window's own call (one step, then two, each
resuming the last's state); the window resumes that state in segments of
``segment_steps`` steps, each ``project(..., state=..., mean_latent=...)``,
as ``cli.project --segments`` does, until ``--seconds`` have passed, then
waits for the card.

End-to-end: ``step_ms``, the window over the Adam steps completed in it.
The check: the first three steps against the reference's
(``reference/invert.py``) from the same inputs. The control: the reference
one precision below, or with the fault ``half_batch`` (half of the batch
left out, each term's mean taken over the rest), against the reference.
"""

from __future__ import annotations

import copy
import json
import sys
import time
from types import SimpleNamespace

import torch

from gar_bench import compare, flops, inputs, peaks, pyramid_work
from gar_bench.common import (DTYPES, exact_float32, load_weights, program_flags, sync,
                              wrap_layers)
from gar_bench.reference import gar, geometry
from gar_bench.reference import invert as ref_invert
from gar_bench.reference.lowp import Precision

FIRST_STEPS = 3
# the end-to-end metric that a reader of what every loop provides moves here
MOVES = "step_ms"


def tiny_traffic(t: dict) -> dict:
    """The traffic of the CPU tests' tiny copy of a cell of this kind."""
    t = copy.deepcopy(t)
    t.update(batch=2, segment_steps=2)
    t["projector"]["mean_latent_draws"] = 64
    return t


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        self.batch = traffic["batch"]
        self.pcfg = traffic["projector"]

    def inputs(self):
        """The face model, the weights and the targets (both sides')."""
        self.face, self.tri = inputs.face_model(self.cfg["mesh"], self.seed, self.dev)
        self.P = inputs.weights(self.cfg, self.seed, self.dev)
        self.target = inputs.targets(self.seed, self.batch, self.cfg["size"],
                                     self.traffic["target_grid"], self.dev)

    # -- set-up ----------------------------------------------------------
    def setup(self):
        from stylerenderer_tpu_torch.face3d import LinearMorphableModel
        from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
        from stylerenderer_tpu_torch.models import GeneratorWithMap

        cfg, m, pc = self.cfg, self.cfg["mesh"], self.pcfg
        program_flags()
        t = time.perf_counter()
        self.inputs()
        sync(self.dev)
        self.phases = {"inputs": time.perf_counter() - t}
        t = time.perf_counter()
        self.gen = GeneratorWithMap(
            cfg["size"], cfg["style_dim"], cfg["n_mlp"], n_stylemap=cfg["n_stylemap"],
            channel_multiplier=cfg["channel_multiplier"], lr_mlp=cfg["lr_mlp"],
            dtype=DTYPES[cfg["precision"]["synthesis"]], pyramid_mode=cfg["pyramid_mode"],
            fused_pyramid=cfg["fused_pyramid"], device=self.dev)
        load_weights(self.gen, self.P)
        model = LinearMorphableModel(self.face["basis"], self.face["mean"], self.face["sigma"],
                                     m["shape_dim"], m["expression_dim"])
        pconf = ProjectorConfig(lr=pc["lr"], lr_geom=pc["lr_geom"], w_pixel_l2=pc["w_pixel_l2"],
                                w_pixel_l1=0.0, w_lpips=0.0, w_lmk=0.0,
                                w_prior=pc["w_prior"], w_pose=pc["w_pose"], w_reg_w=0.0,
                                noise_mode="zero", geo_grad_clip=pc["geo_grad_clip"])
        self.project = make_projector(self.gen, model, self.tri, pconf)
        ms = inputs.mean_latent_seed(self.seed)
        with torch.no_grad():
            self.mean_w = self.gen.mean_latent(pc["mean_latent_draws"],
                                               torch.Generator().manual_seed(ms))
        sync(self.dev)
        self.phases["program"] = time.perf_counter() - t
        # the first steps, through the window's own call
        t = time.perf_counter()
        out1 = self._segment(None, 1)
        sync(self.dev)
        self.phases["step 1"] = time.perf_counter() - t
        t = time.perf_counter()
        out3 = self._segment(out1["state"], FIRST_STEPS - 1)
        b1 = pc["betas"][0]
        params1, opt1 = out1["state"][0], out1["state"][1]["state"]
        order = ref_invert.LEAVES
        # a leaf the optimizer never stepped has no moments: its gradient
        # as the optimizer got it is nought
        self.first = {
            "losses": [float(x) for x in torch.cat([out1["loss_history"],
                                                    out3["loss_history"]]).cpu()],
            "grad": {k: (opt1[i]["exp_avg"] / (1 - b1) if i in opt1
                         else torch.zeros_like(params1[k])) for i, k in enumerate(order)},
            "p3": {k: out3["state"][0][k] for k in order}}
        self.state = out3["state"]
        sync(self.dev)
        self.phases["steps 2-3"] = time.perf_counter() - t

    def _segment(self, state, n: int):
        return self.project(self.seed, self.target, state=state, n_steps=n, return_state=True,
                            mean_latent=self.mean_w)

    # -- the window ------------------------------------------------------
    def _loop(self, seconds: float):
        L, steps, segments = self.traffic["segment_steps"], 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.state = self._segment(self.state, L)["state"]
            steps, segments = steps + L, segments + 1
        sync(self.dev)
        window = time.perf_counter() - t0
        p = self.state[0]
        print(f"window: {steps} steps in {window:.3f} s; scale "
              f"{float(torch.exp(p['log_scale']).mean()):.4f}, |t| "
              f"{float(p['tvec'].norm(dim=1).mean()):.4f}, |x / sigma| "
              f"{float((p['x'] / self.face['sigma']).norm(dim=1).mean()):.4f}",
              file=sys.stderr, flush=True)
        return window, steps, segments

    def window(self, seconds: float) -> dict:
        window_s, steps, _ = self._loop(seconds)
        self.attempted = steps
        return {"step_ms": 1e3 * window_s / steps}

    def traced(self, seconds: float):
        """The window (at most the traffic's ``trace_seconds``) under the
        profiler, with ranges around the instance's ``normal_pyramid`` and
        ``synthesize``."""
        from gar_bench import trace

        wrap_layers(self.gen)
        seconds = min(seconds, self.traffic["trace_seconds"])
        (window_s, steps, segments), tr = trace.run_traced(torch, lambda: self._loop(seconds))
        self.attempted = steps
        # every forward's pyramid is counted at the start's geometry (the
        # mean face, unposed): the work of the later steps' geometry is the
        # program's state, which the count does not read
        with torch.no_grad(), exact_float32():
            p0 = ref_invert.init_params(self.mean_w, self.batch, self.cfg,
                                        self.face["sigma"].shape[0])
            v = geometry.axis_angle_pose(
                geometry.morph(p0["x"], self.face["basis"], self.face["mean"]),
                p0["rvec"], p0["tvec"], p0["log_scale"])
            one = pyramid_work.work(v, self.tri, gar.levels(self.cfg["size"]))["bound_s"]
        forwards = steps + segments  # each segment renders once more at its end
        return SimpleNamespace(
            trace=tr, units=steps, pyramid_bound_s=one * forwards,
            flops_done=flops.forward_flops(self.cfg) * self.batch * (3 * steps + segments),
            peak_flops=peaks.FLOPS_PER_S[self.cfg["precision"]["synthesis"]])

    # -- the check -------------------------------------------------------
    def release(self):
        del self.gen, self.project, self.state
        torch.cuda.empty_cache()

    def reference(self, prec=None, rows=None):
        """The reference's first steps from the same inputs -> its readings
        (``prec``: the control's roundings; ``rows``: the faces kept)."""
        z = inputs.mean_latent_draws(self.seed, self.pcfg["mean_latent_draws"],
                                     self.cfg["style_dim"]).to(self.dev)
        with exact_float32():
            with torch.no_grad():
                q = {} if prec is None else {"q": prec.map}
                mean_w = gar.mapping(self.P, z, self.cfg, **q).mean(0, keepdim=True)
            p0 = ref_invert.init_params(mean_w, self.batch, self.cfg,
                                        self.face["sigma"].shape[0])
            args = {} if prec is None else {"prec": prec}
            losses, grad, p3 = ref_invert.steps(self.P, p0, self.target, self.face, self.tri,
                                                self.cfg, self.pcfg, FIRST_STEPS, rows=rows,
                                                **args)
        return {"losses": losses, "grad": grad, "p0": p0, "p3": p3}

    def check(self) -> dict:
        ref = self.reference()
        p0 = ref_invert.init_params(self.mean_w, self.batch, self.cfg,
                                    self.face["sigma"].shape[0])
        numbers, look = compare.invert_numbers(dict(self.first, p0=p0), ref)
        print(f"look {json.dumps(look)}", file=sys.stderr)
        return numbers


def control_readings(client, traffic, cfg, seed, fault, batches) -> dict:
    """The control's or the fault's numbers (``control.py``): ``client``
    holds the inputs."""
    ref = client.reference()
    if fault == "half_batch":
        other = client.reference(rows=slice(0, client.batch // 2))
    elif fault is None:
        other = client.reference(prec=Precision.below(cfg))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    numbers, look = compare.invert_numbers(other, ref)
    return dict(numbers, look=look)
