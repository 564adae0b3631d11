"""Finding a run's pieces by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix and each metric. The harness finds:

- a configuration ``<config>`` in ``gar_bench/configs/<config>.json``;
- a traffic mix ``<traffic>`` in ``gar_bench/traffic/<traffic>.json``,
  whose ``kind`` names the loop ``gar_bench/loops/<kind>.py``, which holds
  all that is particular to the kind: the ``Loop`` a run drives, the
  control's readings (``control_readings``), the CPU tests' tiny traffic
  (``tiny_traffic``) and the end-to-end metric that a reader of what every
  loop provides moves in its cells (``MOVES``);
- a cell's limits of the check in ``gar_bench/limits/<workload>.json``;
- a per-layer metric ``<name>`` in ``gar_bench/metrics/<name>.py``, else in
  ``gar_bench/metrics/<name before its first dot>.py``.

So a later cell, configuration, traffic mix, loop kind or metric is a new
file and a new entry, with no edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: str = HERE) -> dict:
    return load_json(os.path.join(base, "configs", f"{name}.json"))


def traffic(name: str, base: str = HERE) -> dict:
    return load_json(os.path.join(base, "traffic", f"{name}.json"))


def limits(workload_name: str, base: str = HERE) -> dict:
    return load_json(os.path.join(base, "limits", f"{workload_name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(kind: str, base: str = HERE):
    return _module(os.path.join(base, "loops", f"{kind}.py"), f"gar_bench_loop_{kind}")


def metric_path(name: str, base: str = HERE) -> str:
    for stem in (name, name.split(".")[0]):
        path = os.path.join(base, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}/metrics")


def metric(name: str, base: str = HERE):
    return _module(metric_path(name, base), "gar_bench_metric_" + name.replace(".", "_"))


def moves(reader, kind: str, base: str = HERE) -> str:
    """The end-to-end metric that ``reader``'s metric moves in a cell of loop
    ``kind``: ``reader.MOVES[kind]``, or the loop's own ``MOVES`` where the
    reader declares ``MOVES = "loop"`` (it reads what every loop provides)."""
    if reader.MOVES == "loop":
        return loop(kind, base).MOVES
    return reader.MOVES[kind]


def cell_metrics(bench: dict, section: str, workload_name: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those listing it, and those that list no cells."""
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]
