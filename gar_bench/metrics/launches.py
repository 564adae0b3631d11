"""Device kernels launched a step: the kernels in the traced window over its
optimizer steps (or batches)."""

LAYER = "host"
UNIT = "count"
SOURCE = "device_trace"
MOVES = {"invert": "step_ms", "render": "images_per_s"}


def read(run):
    if not run.units:
        return None
    return run.trace.kernels() / run.units
