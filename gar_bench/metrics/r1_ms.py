"""Device milliseconds an R1 step of the lazy R1 regularization: the
operations that any host thread launched while the window's thread was
inside the program's ``train.r1`` spans (the penalty's forward and double
backward, launched by the autograd engine's thread, and D's second Adam
update), over the number of those spans."""

from gar_bench.span_launches import device_ms_a_range

LAYER = "training"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"train": "step_ms"}


def read(run):
    return device_ms_a_range(run.trace, "train.r1")
