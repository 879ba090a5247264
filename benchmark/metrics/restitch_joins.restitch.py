"""K4 launches per profiled event (the program's counter `restitch.joins`,
one per launch of the re-stitch's pair join): about the rounds with a pair
when the join runs on the card.  None where the program has no such
counter."""
from benchmark import porttrace


def read(trace):
    ids = porttrace.units(trace, porttrace.EVENT)
    if ids is None or not any(
            r[0] == "count" and r[1] == "restitch.joins"
            for r in porttrace.tracer().log):
        return None
    return porttrace.count_per_unit(trace, porttrace.EVENT, "restitch.joins")
