"""Reading a Chrome trace: the window, the union of device intervals, the
device time of operations launched inside named host ranges (by thread),
kernel counts and the breakdown of idle gaps by the host's innermost op."""

import pytest

from gar_bench.trace import WINDOW, Trace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x(WINDOW, "user_annotation", 0, 100),
    _x("gar_bench.synthesize", "user_annotation", 10, 30),
    _x("aten::conv2d", "cpu_op", 12, 5),
    _x("cudaLaunchKernel", "cuda_runtime", 13, 1, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 30, 1, corr=2),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 1, corr=3),
    _x("autograd::engine::evaluate_function: _FusedLevelsBackward", "cpu_op", 55, 20, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 60, 1, tid=2, corr=4),
    _x("conv", "kernel", 15, 20, tid=7, corr=1),
    _x("conv", "kernel", 30, 10, tid=7, corr=2),   # overlaps the first
    _x("add", "kernel", 52, 8, tid=7, corr=3),
    _x("gather", "kernel", 62, 4, tid=7, corr=4),
    _x("Memcpy DtoH", "gpu_memcpy", 90, 20, tid=7, corr=9),  # runs past the window
    _x("aten::copy_", "cpu_op", 70, 25),
]


def test_window_busy_and_ranges():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    # [15, 40] + [52, 60] + [62, 66] + [90, 100]
    assert t.busy_s == pytest.approx(47e-6)
    assert t.kernels() == 4
    assert t.device_s_in(lambda n: n == "gar_bench.synthesize") == pytest.approx(30e-6)
    assert t.device_s_in(lambda n: "_FusedLevelsBackward" in n) == pytest.approx(4e-6)
    assert t.count(lambda n: n == "gar_bench.synthesize") == 1


def test_breakdown():
    b = Trace(EVENTS).breakdown()
    ops = dict(b["device_ops"])
    assert ops["conv"] == pytest.approx(30e-6) and ops["Memcpy DtoH"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    # by each gap's middle: [0, 15), [40, 52), [60, 62) outside any op;
    # [66, 90) in aten::copy_
    assert gaps["aten::copy_"] == pytest.approx(24e-6)
    assert gaps["host outside any op"] == pytest.approx((15 + 12 + 2) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(53e-6)


def test_a_trace_without_the_window_is_an_error():
    with pytest.raises(RuntimeError):
        Trace(EVENTS[1:])
