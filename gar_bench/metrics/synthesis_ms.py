"""Device milliseconds of one synthesis: operations launched inside the
benchmark's ``gar_bench.synthesize`` ranges, over the number of ranges."""

LAYER = "synthesis"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = {"render": "images_per_s", "invert": "step_ms"}
RANGE = "gar_bench.synthesize"


def read(run):
    n = run.trace.count(lambda name: name == RANGE)
    if n == 0:
        return None
    return 1e3 * run.trace.device_s_in(lambda name: name == RANGE) / n
