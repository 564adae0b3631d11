"""Device milliseconds a path step of the lazy path-length regularization:
the operations that any host thread launched while the window's thread was
inside the program's ``train.path`` spans (the path batch's pyramid,
mapping, synthesis and double backward over W+ and the normal levels, and
G's second Adam update), over the number of those spans."""

from gar_bench.span_launches import device_ms_a_range

LAYER = "training"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"train": "step_ms"}


def read(run):
    return device_ms_a_range(run.trace, "train.path")
