"""Device milliseconds a step of the pyramid's backward: operations launched
inside the profiler's ranges of the ``_FusedLevelsBackward`` autograd node,
over the window's optimizer steps."""

LAYER = "pyramid backward"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"invert": "step_ms"}
NODE = "_FusedLevelsBackward"


def read(run):
    t = run.trace.device_s_in(lambda name: NODE in name)
    if t <= 0 or not run.units:
        return None
    return 1e3 * t / run.units
