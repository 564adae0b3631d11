"""The normal pyramid's share of its roofline: the least time of the
pyramids' work in the traced window (``pyramid_work.py``), over the device
time of every operation launched inside the benchmark's
``gar_bench.normal_pyramid`` ranges, in percent."""

LAYER = "normal pyramid"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"render": "images_per_s", "invert": "step_ms"}
RANGE = "gar_bench.normal_pyramid"


def read(run):
    t = run.trace.device_s_in(lambda n: n == RANGE)
    if t <= 0 or not run.pyramid_bound_s:
        return None
    return 100.0 * run.pyramid_bound_s / t
