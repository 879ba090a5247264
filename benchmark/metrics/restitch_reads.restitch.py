"""Device->host reads per profiled event (the program's counter
`restitch.reads`)."""
from benchmark import porttrace


def read(trace):
    return porttrace.count_per_unit(trace, porttrace.EVENT, "restitch.reads")
