"""Device time per depth cloud: the union of the device events' time over
the profiled slice, per frame, in ms."""


def read(trace):
    return trace.busy_us() / trace.units / 1e3 if trace.units else None
