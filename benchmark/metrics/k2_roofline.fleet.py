"""K2's (csrc/features.cu) share of its roofline in its robot-axis launch,
one per fleet frame: the least time of each profiled fleet frame's plane
fit, from the reference's cell counts summed over the robots, over K2's
device time per launch (by symbol)."""
from benchmark import yardstick
from benchmark.tracing import roofline_percent

NEEDS = ("k2",)


def read(trace):
    return roofline_percent(trace, yardstick.K2_SYMBOL,
                            lambda w: yardstick.k2_bound(*w["k2"])[0])
