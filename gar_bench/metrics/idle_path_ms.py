"""Device-idle milliseconds a path step while the window's thread is inside
the program's ``train.path`` spans, over the number of those spans: the
window's thread waits there while the autograd engine's thread launches the
path length's double backward."""

from gar_bench.span_launches import ranges_in_window
from gar_bench.spans import idle_ms_inside

LAYER = "host"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"train": "step_ms"}
NAMES = ("train.path",)


def read(run):
    ms, n = idle_ms_inside(run.trace, NAMES), len(ranges_in_window(run.trace, NAMES[0]))
    return None if ms is None or not n else ms / n
