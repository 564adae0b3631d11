"""The readers of the program's spans on a hand-built trace: the device's
idle time inside named ranges of the window's thread, nested ranges counted
once, ranges on other threads ignored, partial overlaps with the device's
intervals cut exactly, ranges clipped to the window, ``None`` without the
spans; and a traced run of the tiny cells on the CPU, where each metric
reads the program's own spans."""

import json
from types import SimpleNamespace

import pytest
import torch

from gar_bench import run, spec
from gar_bench.spans import idle_ms_inside
from gar_bench.tests import tiny
from gar_bench.trace import WINDOW, Trace

NEW = {"idle_synthesis_ms.render": tiny.RENDER, "idle_front_ms.render": tiny.RENDER,
       "idle_forward_ms.invert": tiny.INVERT, "idle_backward_ms.invert": tiny.INVERT}


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


# device busy [10, 20], [30, 35], [60, 90] of the window [0, 100]
EVENTS = [
    _x(WINDOW, "user_annotation", 0, 100),
    _x("k", "kernel", 10, 10, tid=7),
    _x("k", "kernel", 30, 5, tid=7),
    _x("k", "kernel", 60, 30, tid=7),
    _x("gar.synthesis", "user_annotation", 5, 45),
    _x("synthesis.r4", "user_annotation", 8, 7),            # inside gar.synthesis
    _x("aten::mul", "cpu_op", 12, 2),
    _x("gar.synthesis", "user_annotation", 50, 30, tid=2),  # another thread
    _x("project.backward", "user_annotation", 40, 30),      # half under [60, 90]
    _x("gar.pyramid", "user_annotation", 95, 25),           # past the window's end
    _x("gar.pyramid", "gpu_user_annotation", 0, 100, tid=7),
]


@pytest.fixture(scope="module")
def trace():
    return Trace(EVENTS)


def test_idle_inside_nested_and_other_threads(trace):
    # [5, 50] less [10, 20] and [30, 35]; the other thread's range ignored
    assert idle_ms_inside(trace, ("gar.synthesis",)) == pytest.approx(0.030)
    assert idle_ms_inside(trace, ("gar.synthesis", "synthesis.r4")) == pytest.approx(0.030)
    assert idle_ms_inside(trace, ("synthesis.r4",)) == pytest.approx(0.002)  # [8, 10), [20, 15)


def test_partial_overlaps_and_the_windows_end(trace):
    assert idle_ms_inside(trace, ("project.backward",)) == pytest.approx(0.020)  # [40, 60)
    # [95, 100] inside the window; the card's copy of the range is not the host's
    assert idle_ms_inside(trace, ("gar.pyramid",)) == pytest.approx(0.005)
    # the union of overlapping ranges of different names counts once: [5, 70]
    assert idle_ms_inside(trace, ("gar.synthesis", "project.backward")) == pytest.approx(
        0.065 - 0.015 - 0.010)


def test_none_without_the_spans(trace):
    assert idle_ms_inside(trace, ("train.step",)) is None
    bare = Trace([e for e in EVENTS if e["cat"] != "user_annotation" or e["name"] == WINDOW])
    for name in NEW:
        assert spec.metric(name).read(SimpleNamespace(trace=bare, units=3)) is None


def test_readers_per_unit(trace):
    r = SimpleNamespace(trace=trace, units=2)
    assert spec.metric("idle_synthesis_ms.render").read(r) == pytest.approx(0.015)
    assert spec.metric("idle_backward_ms.invert").read(r) == pytest.approx(0.010)
    assert spec.metric("idle_front_ms.render").read(r) == pytest.approx(0.0025)
    assert spec.metric("idle_forward_ms.invert").read(r) is None
    assert spec.metric("idle_synthesis_ms.render").read(SimpleNamespace(trace=trace,
                                                                        units=0)) is None


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_a_traced_run_reads_the_programs_spans(tmp_path, capsys, monkeypatch, workload):
    root = tiny.layout(tmp_path)
    # the traced window ends in a wait for the card, which the CPU has not
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    assert run.main(["--workload", workload, "--seed", "9", "--seconds", "0.2", "--trace", "1"],
                    root=root, device=torch.device("cpu"), base=root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the cell's metrics whose readers read the program's spans (``NAMES``)
    got = {m["name"] for m in spec.cell_metrics(spec.benchmark(root), "per_layer", workload)
           if hasattr(spec.metric(m["name"], root), "NAMES")}
    assert {name for name, cell in NEW.items() if cell == workload} <= got
    assert got <= set(out["metrics"]) and out["correct"] is True
    # no device intervals on the CPU: each reads the host's time inside its spans
    assert all(out["metrics"][name]["value"] > 0 for name in got)
