"""The normal pyramid's share of its roofline in a training cell:
``pyramid_roofline.py``'s reading (the least time of the pyramids the traced
steps computed, over the device time of the operations launched inside the
``gar_bench.normal_pyramid`` ranges, in percent), moving ``step_ms``."""

from gar_bench.metrics.pyramid_roofline import LAYER, RANGE, SOURCE, UNIT, read  # noqa: F401

MOVES = {"train": "step_ms"}
