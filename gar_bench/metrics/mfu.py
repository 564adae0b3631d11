"""The whole step's share of the card's peak: the benchmark's count of the
GAR's operations done in the traced window (``flops.py``), over the window,
over the peak of the precision the configuration's convolutions run in
(``peaks.py``), in percent."""

LAYER = "whole forward or step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "loop"  # the end-to-end metric its cell's loop declares


def read(run):
    if not run.flops_done or run.trace.window_s <= 0:
        return None
    return 100.0 * run.flops_done / run.trace.window_s / run.peak_flops
