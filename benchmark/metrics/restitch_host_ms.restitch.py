"""Host time of `apply_loop_closure` per profiled event, in ms, less the
time its reads and uploads spend (each waits for the device): the host's
own work (pair selection, scheduling, launches)."""
from benchmark import porttrace


def read(trace):
    parts = [porttrace.span_ms(trace, porttrace.EVENT, f"gem.restitch.{n}")
             for n in ("apply", "read", "upload")]
    if parts[0] is None:
        return None
    return parts[0] - parts[1] - parts[2]
