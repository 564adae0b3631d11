"""The program's own spans in a traced window (``trace_ctx`` ranges of the
port, listed in ``stylerenderer_tpu_torch/utils/logging.py::SPANS``): how
long the device sat idle while the host was inside them.

They are ``record_function`` ranges on the profiler's timeline, the clock
of the device's intervals, so the two are intersected directly. A program
that emits no such span (an older port) gives ``None``, and its metrics
are left out of the result line.
"""

from __future__ import annotations

from gar_bench.trace import _union


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_inside(trace, names) -> float | None:
    """Milliseconds of ``trace``'s window in which the device is idle (outside
    ``trace.busy``) while the window's thread is inside a range named in
    ``names``, at any depth (nested and repeated ranges count once), or
    ``None`` when that thread opened no such range in the window."""
    spans = [(max(s, trace.t0), min(e, trace.t1))
             for s, e, name in trace.host.get(trace.main_tid, []) if name in names]
    inside = _union((s, e) for s, e in spans if e > s)
    if not inside:
        return None
    return 1e-3 * (sum(e - s for s, e in inside) - _overlap(inside, trace.busy))


def idle_ms_a_unit(run, names) -> float | None:
    """``idle_ms_inside`` over the traced window's batches or optimizer steps
    (``run.units``)."""
    ms = idle_ms_inside(run.trace, names)
    if ms is None or not run.units:
        return None
    return ms / run.units
