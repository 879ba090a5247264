"""Mean host-clock time of `ElevationPipeline.process` per frame, until it
returns with no synchronise (the input copies, the graph replay, the
output copies), over the window."""
from benchmark.tracing import mean_ms


def read(trace):
    return mean_ms(trace, "enqueue")
