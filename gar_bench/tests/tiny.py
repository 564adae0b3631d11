"""A tiny copy of the benchmark's cells for the CPU tests: every cell's
configuration cut to 16 px, a 352-triangle sphere face, and its traffic cut
by its loop's own ``tiny_traffic``; held to the real cells' limits; laid
out as a checkout (``BENCHMARK.json``) and a base of data files, with the
real loops and metrics."""

from __future__ import annotations

import copy
import json
import os
import shutil

from gar_bench import spec

ROOT = os.path.dirname(spec.HERE)
RENDER, INVERT = "tiny.render", "tiny.invert"
# the tiny names of the first two cells; every other cell's is tiny.<its name>
NAMES = {"gar1024.render.b16": RENDER, "gar256.invert.b32": INVERT}


def name(cell: str) -> str:
    return NAMES.get(cell, f"tiny.{cell}")


# the tiny name of every cell of the repository's BENCHMARK.json
CELLS = [name(w["name"]) for w in spec.benchmark(ROOT)["workloads"]]


def shrink(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    c.update(size=16, style_dim=32, n_mlp=2)
    c["mesh"].update(nu=12, nv=16, triangles=2 * 11 * 16, shape_dim=4, expression_dim=3)
    return c


def layout(tmp, source: str = ROOT) -> str:
    """Write the tiny checkout of every cell of ``source``'s
    ``BENCHMARK.json`` (its files under ``source``/gar_bench) under ``tmp``
    -> its root (also the base)."""
    root, base = str(tmp), os.path.join(source, "gar_bench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for d in ("loops", "metrics"):
        shutil.copytree(os.path.join(base, d), os.path.join(root, d), dirs_exist_ok=True)
    bench = spec.benchmark(source)
    names = {w["name"]: name(w["name"]) for w in bench["workloads"]}
    tiny = []
    for w in bench["workloads"]:
        n = names[w["name"]]
        _dump(root, "configs", n, shrink(spec.config(w["config"], base)))
        t = spec.traffic(w["traffic"], base)
        _dump(root, "traffic", n, spec.loop(t["kind"], base).tiny_traffic(t))
        _dump(root, "limits", n, spec.limits(w["name"], base))
        tiny.append(dict(w, name=n, config=n, traffic=n))
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
