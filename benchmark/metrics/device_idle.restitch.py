"""The share of the profiled events (their timed spans) in which the
device ran nothing."""
from benchmark.tracing import idle_percent


def read(trace):
    return idle_percent(trace, "event")
