"""Device events (kernels, copies, fills) per frame over the profiled
slice."""


def read(trace):
    return len(trace.device) / trace.units if trace.units else None
