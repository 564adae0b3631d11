"""Device-idle milliseconds an optimizer step while the host is inside the
program's ``project.forward`` spans (the projector's render and loss), over
the window's steps."""

from gar_bench.spans import idle_ms_a_unit

LAYER = "host"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"invert": "step_ms"}
NAMES = ("project.forward",)


def read(run):
    return idle_ms_a_unit(run, NAMES)
