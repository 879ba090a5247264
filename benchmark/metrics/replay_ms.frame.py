"""Host time of `gem.program.replay` per frame over the profiled slice, in
ms: the program's own span in `DeviceProgram` (utils/graph.py)."""
from benchmark import porttrace


def read(trace):
    return porttrace.span_ms(trace, porttrace.FRAME, "gem.program.replay")
