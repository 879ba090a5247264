"""Device time per re-stitch event: the union of the device events' time
inside the events' timed spans, per event, in ms."""


def read(trace):
    busy, _ = trace.within("event")
    return busy / trace.units / 1e3 if trace.units else None
