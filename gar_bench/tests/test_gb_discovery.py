"""The harness finds a cell's pieces by name: a new configuration, traffic
mix, limits file and per-layer metric placed as new files are found with
no edit, and so is a new loop kind, whose cell runs, is checked, has its
control read and its tiny copy laid out; every metric of BENCHMARK.json has
a reader that declares what the entry says, in each cell it lists."""

import json
import os
import shutil

import pytest
import torch

from gar_bench import control, run, spec
from gar_bench.compare import judge
from gar_bench.tests import tiny

ROOT = os.path.dirname(spec.HERE)


def check_readers(bench: dict, base: str = spec.HERE) -> None:
    """Each per-layer entry's reader declares the entry's unit, source and
    layer, and, in each cell the entry lists (every cell where it lists
    none), by that cell's loop kind, the end-to-end metric it moves, which
    the cell reports; each cell's pieces are found."""
    kinds = {w["name"]: spec.traffic(w["traffic"], base)["kind"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        mod = spec.metric(m["name"], base)
        assert (mod.UNIT, mod.SOURCE, mod.LAYER) == (m["unit"], m["source"], m["layer"])
        for w in m.get("workloads", kinds):
            assert spec.moves(mod, kinds[w], base) == m["moves"], (m["name"], w)
            assert m["moves"] in [e["name"] for e in spec.cell_metrics(bench, "end_to_end", w)]
    for w in bench["workloads"]:
        spec.config(w["config"], base), spec.limits(w["name"], base)
        loop = spec.loop(kinds[w["name"]], base)
        assert callable(loop.tiny_traffic) and callable(loop.control_readings)
        assert loop.MOVES in [e["name"] for e in spec.cell_metrics(bench, "end_to_end", w["name"])]


def test_every_metric_reader_agrees_with_its_entry():
    check_readers(spec.benchmark(ROOT))


def test_new_files_are_found_by_name(tmp_path, capsys):
    root = tiny.layout(tmp_path)
    bench = spec.benchmark(root)
    base_cell = spec.workload(bench, tiny.RENDER)
    # a configuration, a traffic mix and limits of a new cell, as new files
    cfg = spec.config(base_cell["config"], root)
    cfg["style_dim"] = 16
    tiny._dump(root, "configs", "dummy", cfg)
    tr = spec.traffic(base_cell["traffic"], root)
    tr["batch"] = 1
    tiny._dump(root, "traffic", "dummy.mix", tr)
    tiny._dump(root, "limits", "dummy.cell", spec.limits(tiny.RENDER, root))
    with open(os.path.join(root, "metrics", "dummy_metric.py"), "w") as f:
        f.write("LAYER = 'x'\nUNIT = 'count'\nSOURCE = 'device_trace'\n"
                "def read(run):\n    return 42.0\n")
    bench["workloads"].append(dict(base_cell, name="dummy.cell", config="dummy",
                                   traffic="dummy.mix"))
    bench["per_layer"].append({"name": "dummy_metric.extra", "unit": "count", "better": "lower",
                               "source": "device_trace", "layer": "x",
                               "moves": "images_per_s", "workloads": ["dummy.cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    assert spec.config("dummy", root)["style_dim"] == 16
    assert spec.traffic("dummy.mix", root)["batch"] == 1
    assert spec.metric("dummy_metric.extra", root).read(None) == 42.0
    assert [m["name"] for m in spec.cell_metrics(bench, "per_layer", "dummy.cell")] == [
        "dummy_metric.extra"]
    rc = run.main(["--workload", "dummy.cell", "--seed", "5", "--seconds", "0.1"], root=root,
                  device=torch.device("cpu"), base=root)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] and out["attempted"] >= 1


def test_a_missing_reader_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        spec.metric_path("no_such_metric.render", str(tmp_path))


# a loop kind that the harness has never seen: a closed loop of float32
# matrix products, checked against float64; its control computes in bfloat16
DUMMY_LOOP = '''
import time
from types import SimpleNamespace

import torch

from gar_bench import compare, inputs, trace

MOVES = "products_per_s"


def tiny_traffic(t):
    return dict(t, n=8)


class Loop:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device

    def inputs(self):
        n = self.traffic["n"]
        self.a = torch.randn(n, n, generator=inputs.stream(self.seed, "dummy", 0, self.dev),
                             device=self.dev)

    def setup(self):
        self.inputs()
        self.phases = {}

    def _loop(self, seconds):
        n, t0 = 0, time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.out, n = self.a @ self.a, n + 1
        return time.perf_counter() - t0, n

    def window(self, seconds):
        s, self.attempted = self._loop(seconds)
        return {"products_per_s": self.attempted / s}

    def traced(self, seconds):
        (_, self.attempted), tr = trace.run_traced(torch, lambda: self._loop(seconds))
        return SimpleNamespace(trace=tr, units=self.attempted)

    def release(self):
        pass

    def reference(self):
        return self.a.double() @ self.a.double()

    def check(self):
        return {"rel_gap": compare.rel_l2(self.out, self.reference())}


def control_readings(client, traffic, cfg, seed, fault, batches):
    low = client.a.to(torch.bfloat16).float()
    return {"rel_gap": compare.rel_l2(low @ low, client.reference())}
'''


def test_a_new_loop_kind_is_new_files_only(tmp_path, capsys, monkeypatch):
    """A checkout of the benchmark gains, as new files and new entries only,
    a cell of a new loop kind with a per-layer entry that reuses the generic
    ``idle_share.py``: its readers check, its tiny copy is laid out beside
    every other cell's, it runs correct on the CPU (also traced), and its
    control fails its limits."""
    src = tmp_path / "checkout"
    shutil.copytree(spec.HERE, src / "gar_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), src)
    base = str(src / "gar_bench")
    (src / "gar_bench" / "loops" / "products.py").write_text(DUMMY_LOOP)
    tiny._dump(base, "configs", "dummy256", spec.config("gar256"))
    tiny._dump(base, "traffic", "products.n512", {"kind": "products", "n": 512})
    tiny._dump(base, "limits", "dummy256.products.n512", {"rel_gap": 1e-4})
    bench = spec.benchmark(str(src))
    bench["workloads"].append({"name": "dummy256.products.n512", "config": "dummy256",
                               "traffic": "products.n512", "chips": 1, "why": "a new kind"})
    bench["end_to_end"].append({"name": "products_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["dummy256.products.n512"]})
    bench["per_layer"].append({"name": "idle_share.products", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "products_per_s", "workloads": ["dummy256.products.n512"]})
    with open(src / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    check_readers(bench, base)

    root = tiny.layout(tmp_path / "tiny", source=str(src))
    new = "tiny.dummy256.products.n512"
    small = spec.benchmark(root)
    assert [w["name"] for w in small["workloads"]] == tiny.CELLS + [new]
    assert spec.traffic(new, root) == {"kind": "products", "n": 8}
    check_readers(small, root)
    for workload in tiny.CELLS + [new]:
        spec.config(workload, root), spec.limits(workload, root)

    cpu = torch.device("cpu")
    assert run.main(["--workload", new, "--seed", str(2**33 + 1), "--seconds", "0.1"], root=root,
                    device=cpu, base=root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True and set(out["metrics"]) == {"products_per_s", "setup_s"}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    assert run.main(["--workload", new, "--seed", "3", "--seconds", "0.1", "--trace", "1"],
                    root=root, device=cpu, base=root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True and set(out["metrics"]) == {"idle_share.products"}

    for checkout, where, cell in ((str(src), base, "dummy256.products.n512"), (root, root, new)):
        wl = spec.workload(spec.benchmark(checkout), cell)
        numbers = control.readings(wl, 5, None, 20, base=where, device=cpu)
        assert not judge(numbers, spec.limits(cell, where))[0], numbers
