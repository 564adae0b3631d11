"""The traced window: ``torch.profiler`` over the window's calls, its Chrome
trace read back into device intervals, kernel launches and host ranges.

- busy: the union of the device's kernel, copy and set intervals inside the
  window (so overlapping streams count once);
- ranges: host ranges by name (``record_function`` ranges that the loops
  wrap around layers, and the profiler's own op and autograd-node ranges),
  each on its host thread; a kernel belongs to a range when the host call
  that launched it lies inside the range on the same thread;
- breakdown: the device operations that took most time, and the device's
  idle gaps summed by the innermost host range open on the window's thread
  at each gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "gar_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def run_traced(torch, fn):
    """Run ``fn`` under the profiler inside a ``gar_bench.window`` range that
    ends after a device synchronisation -> (``fn``'s result, ``Trace``)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="gar_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)


def _union(intervals):
    """Sorted, merged ``[(start, end)]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """A Chrome trace of one window (times in microseconds)."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X"]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
        if not win:
            raise RuntimeError("the trace holds no window range")
        w = max(win, key=lambda e: e["dur"])
        self.t0, self.t1, self.main_tid = w["ts"], w["ts"] + w["dur"], w.get("tid")
        self.device = []  # (start, end, name, correlation)
        self.launch = {}  # correlation -> (ts, tid)
        self.host = defaultdict(list)  # tid -> [(start, end, name)]
        for e in xs:
            cat, ts, dur = e.get("cat"), e["ts"], e.get("dur", 0)
            if cat in DEVICE_CATS:
                s, t = max(ts, self.t0), min(ts + dur, self.t1)
                if t > s:
                    self.device.append((s, t, e["name"], cat,
                                        e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (ts, e.get("tid"))
            elif cat in HOST_CATS:
                self.host[e.get("tid")].append((ts, ts + dur, e["name"]))
        for v in self.host.values():
            v.sort()
        self.busy = _union((s, t) for s, t, *_ in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) * 1e-6

    def kernels(self) -> int:
        return sum(1 for d in self.device if d[3] == "kernel")

    def ranges(self, match) -> dict:
        """Host ranges whose name ``match(name)`` accepts, by thread."""
        return {tid: [r for r in v if match(r[2])] for tid, v in self.host.items()}

    def count(self, match) -> int:
        return sum(len(v) for v in self.ranges(match).values())

    def device_s_in(self, match) -> float:
        """Seconds of device operations launched inside a host range whose
        name ``match`` accepts (each operation counted once)."""
        by_tid = {}
        for tid, rs in self.ranges(match).items():
            if rs:
                u = _union((s, e) for s, e, _ in rs)
                by_tid[tid] = ([s for s, _ in u], [e for _, e in u])
        total = 0.0
        for s, t, _, _, corr in self.device:
            ts, tid = self.launch.get(corr, (None, None))
            if ts is None or tid not in by_tid:
                continue
            starts, ends = by_tid[tid]
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts < ends[i]:
                total += t - s
        return total * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for s, t, name, _, _ in self.device:
            ops[name] += (t - s) * 1e-6
        gaps = defaultdict(float)
        host = self.host.get(self.main_tid, [])
        starts = [h[0] for h in host]
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                gaps[self._innermost(host, starts, 0.5 * (g0 + g1))] += (g1 - g0) * 1e-6
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}

    @staticmethod
    def _innermost(host, starts, t, reach: int = 4096) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            s, e, name = host[j]
            if s <= t < e and name != WINDOW:
                return name
        return "host outside any op"
