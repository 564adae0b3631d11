"""Device time of the work that a span of the program's own launched, by
time: an operation belongs to a span when the host call that launched it,
on any thread, lies inside one of the span's ranges on the window's
thread. Inside ``train.r1`` and ``train.path`` the window's thread waits
in ``torch.autograd.grad`` while the autograd engine's thread launches the
backward's kernels, so ``Trace.device_s_in``, which matches a launch to a
range on the launching thread, misses them. Nothing else runs on the host
meanwhile: the window's thread is blocked until the engine is done.
"""

from __future__ import annotations

import bisect

from gar_bench.trace import _union


def ranges_in_window(trace, name: str) -> list[tuple[float, float]]:
    """The ranges named ``name`` that the window's thread opened in the
    window."""
    return [(s, e) for s, e, n in trace.host.get(trace.main_tid, [])
            if n == name and trace.t0 <= s < trace.t1]


def device_ms_a_range(trace, name: str) -> float | None:
    """Device milliseconds of the operations launched while the window's
    thread is inside a range named ``name``, over the number of such
    ranges in the window, or ``None`` when there is none."""
    ranges = ranges_in_window(trace, name)
    if not ranges:
        return None
    inside = _union(ranges)
    starts = [s for s, _ in inside]
    total = 0.0
    for s, t, _, _, corr in trace.device:
        ts = trace.launch.get(corr, (None, None))[0]
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < inside[i][1]:
            total += t - s
    return 1e-3 * total / len(ranges)
