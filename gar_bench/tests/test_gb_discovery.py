"""The harness finds a cell's pieces by name: a new configuration, traffic
mix, limits file and per-layer metric placed as new files are found with
no edit; every metric of BENCHMARK.json has a reader that declares what the
entry says."""

import json
import os

import pytest
import torch

from gar_bench import run, spec
from gar_bench.tests import tiny

ROOT = os.path.dirname(spec.HERE)


def test_every_metric_reader_agrees_with_its_entry():
    bench = spec.benchmark(ROOT)
    for m in bench["per_layer"]:
        mod = spec.metric(m["name"])
        suffix = m["name"].split(".", 1)[-1]
        assert (mod.UNIT, mod.SOURCE, mod.LAYER) == (m["unit"], m["source"], m["layer"])
        assert mod.MOVES[suffix] == m["moves"]
    for w in bench["workloads"]:
        spec.config(w["config"]), spec.traffic(w["traffic"]), spec.limits(w["name"])
        spec.loop(spec.traffic(w["traffic"])["kind"])


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
