"""The share of the profiled slice in which the device ran nothing."""
from benchmark.tracing import idle_percent


def read(trace):
    return idle_percent(trace)
