"""K2's (csrc/features.cu) share of its roofline: the least time of each
profiled frame's plane fit, from the reference's count of fitted cells,
over K2's device time per launch (by symbol)."""
from benchmark import yardstick
from benchmark.tracing import roofline_percent

NEEDS = ("k2",)


def read(trace):
    return roofline_percent(trace, yardstick.K2_SYMBOL,
                            lambda w: yardstick.k2_bound(*w["k2"])[0])
