"""Device-idle milliseconds a batch while the host is inside the program's
spans before the synthesis: the morphable model, the pose and the normals
(``geometry.*``), the mapping network (``gar.mapping``) and the normal
pyramid (``gar.pyramid``), over the window's batches."""

from gar_bench.spans import idle_ms_a_unit

LAYER = "geometry, mapping and pyramid"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"render": "images_per_s"}
NAMES = ("geometry.morph", "geometry.pose", "geometry.normals", "gar.mapping", "gar.pyramid")


def read(run):
    return idle_ms_a_unit(run, NAMES)
