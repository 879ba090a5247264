"""Host time in `gem.restitch.read` per profiled event, in ms: the
device->host reads of `apply_loop_closure`, each waiting for every
operation queued before it."""
from benchmark import porttrace


def read(trace):
    return porttrace.span_ms(trace, porttrace.EVENT, "gem.restitch.read")
