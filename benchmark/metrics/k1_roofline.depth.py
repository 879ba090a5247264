"""K1's (csrc/fuse_stream.cu) share of its roofline on dense clouds, tens
to hundreds of points a cell: the least time of each profiled frame's
aggregate, from the reference's counts of points in cells and occupied
cells, over K1's device time per launch (by symbol)."""
from benchmark import yardstick
from benchmark.tracing import roofline_percent

NEEDS = ("k1",)


def read(trace):
    return roofline_percent(trace, yardstick.K1_SYMBOL,
                            lambda w: yardstick.k1_bound(*w["k1"])[0])
