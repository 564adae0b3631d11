"""The device's idle share of the traced window: 1 - (union of its kernel,
copy and set intervals) / window, in percent."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "loop"  # the end-to-end metric its cell's loop declares


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
