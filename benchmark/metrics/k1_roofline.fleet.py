"""K1's (csrc/fuse_stream.cu) share of its roofline in its robot-axis
launch, one per fleet frame: the least time of each profiled fleet frame's
aggregate, from the reference's counts summed over the robots, over K1's
device time per launch (by symbol)."""
from benchmark import yardstick
from benchmark.tracing import roofline_percent

NEEDS = ("k1",)


def read(trace):
    return roofline_percent(trace, yardstick.K1_SYMBOL,
                            lambda w: yardstick.k1_bound(*w["k1"])[0])
