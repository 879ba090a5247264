"""The bytes the program copies into its graph's static inputs per frame of
the profiled slice, in MB (1e6 bytes): the program's counter
`program.bytes_in` (utils/graph.py `DeviceProgram`, the input leaves'
bytes, counted on each replay).  None where the program has no such
counter."""
from benchmark import porttrace


def read(trace):
    ids = porttrace.units(trace, porttrace.FRAME)
    if ids is None or not any(
            r[0] == "count" and r[1] == "program.bytes_in"
            for r in porttrace.tracer().log):
        return None
    return porttrace.count_per_unit(trace, porttrace.FRAME,
                                    "program.bytes_in") / 1e6
