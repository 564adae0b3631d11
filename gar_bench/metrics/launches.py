"""Device kernels launched a step: the kernels in the traced window over its
optimizer steps (or batches)."""

LAYER = "host"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "loop"  # the end-to-end metric its cell's loop declares


def read(run):
    if not run.units:
        return None
    return run.trace.kernels() / run.units
