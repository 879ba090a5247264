"""Branches that took the select route per fleet frame of the profiled
slice (the program's counter `control.selects`, counted again on each
replay of a captured graph): the masked bodies a fleet frame runs whatever
its robots' predicates.  None where the program has no such counter."""
from benchmark import porttrace


def read(trace):
    ids = porttrace.units(trace, porttrace.FRAME)
    if ids is None or not any(
            r[0] == "count" and r[1] == "control.selects"
            for r in porttrace.tracer().log):
        return None
    return porttrace.count_per_unit(trace, porttrace.FRAME, "control.selects")
