"""Generation: ``cli.generate --with_map``'s path, a closed loop of one
client. Each batch draws its 3DMM coefficients, pose, latents and noise on
the card from the seed, poses the program's morphable model
(``LinearMorphableModel``, ``apply_pose3D``, ``mesh_point_normal``), runs
``GeneratorWithMap.forward`` and copies the images, as the program gives
them, into a pinned host buffer that the client reuses.

End-to-end: ``images_per_s`` (images on the host over the window) and
``latency_p95_ms`` (each batch from the draws to its images on the host).
The check: a sample of the window's batches drawn from the seed, one image
of each, against the reference (``reference/render.py``). The control: the
same number of images, sampled alike, of the reference one precision below
against the reference.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from gar_bench import compare, flops, inputs, peaks, pyramid_work
from gar_bench.common import (DTYPES, Reservoir, exact_float32, load_weights, program_flags,
                              sync, wrap_layers)
from gar_bench.reference import gar
from gar_bench.reference import render as ref_render
from gar_bench.reference.lowp import Precision

# the end-to-end metric that a reader of what every loop provides moves here
MOVES = "images_per_s"


def tiny_traffic(t: dict) -> dict:
    """The traffic of the CPU tests' tiny copy of a cell of this kind."""
    return dict(t, batch=2, warmup_batches=1, images_checked=2)


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        self.batch = traffic["batch"]
        self.sample = Reservoir(traffic["images_checked"], seed)
        self.host, self.pin = None, torch.device(device).type == "cuda"

    def inputs(self):
        """The face model and the weights (both sides')."""
        self.face, self.tri = inputs.face_model(self.cfg["mesh"], self.seed, self.dev)
        self.P = inputs.weights(self.cfg, self.seed, self.dev)

    # -- set-up ----------------------------------------------------------
    def setup(self):
        from stylerenderer_tpu_torch.face3d import LinearMorphableModel
        from stylerenderer_tpu_torch.face3d.geometry import apply_pose3D, mesh_point_normal
        from stylerenderer_tpu_torch.models import GeneratorWithMap

        cfg, m = self.cfg, self.cfg["mesh"]
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
            fused_pyramid=cfg["fused_pyramid"], device=self.dev).eval()
        load_weights(self.gen, self.P)
        self.model = LinearMorphableModel(self.face["basis"], self.face["mean"],
                                          self.face["sigma"], m["shape_dim"],
                                          m["expression_dim"])
        self._pose, self._normals = apply_pose3D, mesh_point_normal
        sync(self.dev)
        self.phases["program"] = time.perf_counter() - t
        for i in range(self.traffic["warmup_batches"]):
            t = time.perf_counter()
            self._batch(-1 - i)
            sync(self.dev)
            self.phases[f"warm batch {i}"] = time.perf_counter() - t

    def _batch(self, index: int):
        """One timed unit: batch ``index``'s draws to its images on the host."""
        d = inputs.render_draws(self.seed, index, self.batch, self.cfg, self.traffic,
                                self.face, self.dev)
        with torch.no_grad():
            vert = self._pose(self.model(d["x"]), d["pose"])
            norm = self._normals(vert, self.tri)
            img, _, maps = self.gen([d["z"]], (vert, norm, self.tri), return_normals=True,
                                    noise=d["noise"])
            if self.host is None:
                self.host = torch.empty(img.shape, dtype=img.dtype, pin_memory=self.pin)
            self.host.copy_(img, non_blocking=self.pin)
            sync(self.dev)
        return self.host, maps

    # -- the window ------------------------------------------------------
    def _loop(self, seconds: float):
        lat, n = [], 0
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            host, maps = self._batch(n)
            lat.append(time.perf_counter() - t)
            j = self.sample.pick(self.batch)
            self.sample.offer(lambda: (n, j, host[j].clone(), [m[j].clone() for m in maps]))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return time.perf_counter() - t0, n, lat

    def window(self, seconds: float) -> dict:
        window_s, n, lat = self._loop(seconds)
        self.attempted = n * self.batch
        return {"images_per_s": n * self.batch / window_s,
                "latency_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def traced(self, seconds: float):
        """The window (at most the traffic's ``trace_seconds``) under the
        profiler, with ranges around the instance's ``normal_pyramid`` and
        ``synthesize``."""
        from gar_bench import trace

        wrap_layers(self.gen)
        seconds = min(seconds, self.traffic["trace_seconds"])
        (window_s, n, _), tr = trace.run_traced(torch, lambda: self._loop(seconds))
        self.attempted = n * self.batch
        sizes = gar.levels(self.cfg["size"])
        bound = 0.0
        for i in range(n):
            d = inputs.render_draws(self.seed, i, self.batch, self.cfg, self.traffic,
                                    self.face, self.dev)
            with torch.no_grad(), exact_float32():
                v = ref_render.posed(self.face, d["x"], d["pose"])
                bound += pyramid_work.work(v, self.tri, sizes)["bound_s"]
        return SimpleNamespace(
            trace=tr, units=n, pyramid_bound_s=bound,
            flops_done=flops.forward_flops(self.cfg) * n * self.batch,
            peak_flops=peaks.FLOPS_PER_S[self.cfg["precision"]["synthesis"]])

    # -- the check -------------------------------------------------------
    def release(self):
        del self.gen, self.model
        torch.cuda.empty_cache()

    def reference(self, i: int, j: int, prec=None):
        """The reference's normal maps and image ``j`` of batch ``i``
        (``prec``: the control's roundings)."""
        d = inputs.render_draws(self.seed, i, self.batch, self.cfg, self.traffic, self.face,
                                self.dev)
        args = {} if prec is None else {"prec": prec}
        with torch.no_grad(), exact_float32():
            return ref_render.image(self.P, self.face, self.tri, self.cfg, d, j, **args)

    def check(self) -> dict:
        tally = compare.RenderTally()
        for i, j, host, maps in self.sample.items:
            tally.add([m[None] for m in maps], host[None],
                      *self.reference(i, j))
        return tally.numbers()


def control_readings(client, traffic, cfg, seed, fault, batches) -> dict:
    """The control's numbers (``control.py``): ``client`` holds the inputs;
    the sample is drawn as a window of ``batches`` batches draws it."""
    if fault is not None:
        raise ValueError("generation has no planted fault here: its fault test alters an image")
    sample = Reservoir(traffic["images_checked"], seed)
    for n in range(batches):
        j = sample.pick(client.batch)
        sample.offer(lambda: (n, j))
    tally = compare.RenderTally()
    low = Precision.below(cfg)
    for i, j in sample.items:
        tally.add(*client.reference(i, j, prec=low), *client.reference(i, j))
    return tally.numbers()
