"""Device-idle milliseconds an optimizer step while the host is inside the
program's ``project.backward`` spans, over the window's steps: the window's
thread waits there while the autograd engine's thread launches the
backward's kernels."""

from gar_bench.spans import idle_ms_a_unit

LAYER = "host"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"invert": "step_ms"}
NAMES = ("project.backward",)


def read(run):
    return idle_ms_a_unit(run, NAMES)
