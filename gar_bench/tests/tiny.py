"""A tiny copy of the benchmark's cells for the CPU tests: the real cells'
configurations cut to 16 px, a 352-triangle sphere face and batches of 2,
held to the real cells' limits; laid out as a checkout (``BENCHMARK.json``)
and a base of data files, with the real loops and metrics."""

from __future__ import annotations

import copy
import json
import os
import shutil

from gar_bench import spec

RENDER, INVERT = "tiny.render", "tiny.invert"


def shrink(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    c.update(size=16, style_dim=32, n_mlp=2)
    c["mesh"].update(nu=12, nv=16, triangles=2 * 11 * 16, shape_dim=4, expression_dim=3)
    return c


def layout(tmp) -> str:
    """Write the tiny checkout under ``tmp`` -> its root (also the base)."""
    root = str(tmp)
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for d in ("loops", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, d), os.path.join(root, d), dirs_exist_ok=True)
    bench = spec.benchmark(os.path.dirname(spec.HERE))
    cells = {w["name"]: w for w in bench["workloads"]}
    names = {"gar1024.render.b16": RENDER, "gar256.invert.b32": INVERT}
    tiny = []
    for real, name in names.items():
        w = cells[real]
        _dump(root, "configs", name, shrink(spec.config(w["config"])))
        t = spec.traffic(w["traffic"])
        t["batch"] = 2
        if t["kind"] == "render":
            t.update(warmup_batches=1, images_checked=2)
        else:
            t.update(segment_steps=2)
            t["projector"]["mean_latent_draws"] = 64
        _dump(root, "traffic", name, t)
        _dump(root, "limits", name, spec.limits(real))
        tiny.append(dict(w, name=name, config=name, traffic=name))
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "workloads" in m:
                m["workloads"] = [names[x] for x in m["workloads"]]
    bench["workloads"] = tiny
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _dump(root, sub, name, obj):
    with open(os.path.join(root, sub, f"{name}.json"), "w") as f:
        json.dump(obj, f)
