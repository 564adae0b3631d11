"""Device-idle milliseconds a batch while the host is inside the program's
``gar.synthesis`` spans (``GeneratorWithMap.synthesize``): the synthesis's
launches that leave the card waiting, over the window's batches."""

from gar_bench.spans import idle_ms_a_unit

LAYER = "synthesis"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"render": "images_per_s"}
NAMES = ("gar.synthesis",)


def read(run):
    return idle_ms_a_unit(run, NAMES)
