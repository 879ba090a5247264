"""What the program's own tracer (gem_tpu_torch/utils/observability.py
`TRACER`) recorded over a traced run's profiled slice, for the readers of
the metrics that read it (benchmark/metrics/).

While a profiler records, the tracer keeps its spans and counts in its log,
each with its unit, with the tracer itself off: no device work and no
graph node is added, so the slice's device events are the parent's.  The
profiled slice is a run's only profile: the last `trace.units` units of a
kind in the log are the slice's frames or events.  A unit's kind is the
span it holds: `gem.program.replay` for a `DeviceProgram` call (a frame),
`gem.restitch.apply` for a re-stitch event.  The spans' times are the
host's under the profiler, which slows some of them (PERF.md section 3).

Against a program without the tracer every function returns None, so a
reader reports nothing there and raises nothing.
"""

from __future__ import annotations

FRAME = "gem.program.replay"
EVENT = "gem.restitch.apply"


def tracer():
    """The program's tracer, or None in a program without one."""
    try:
        from gem_tpu_torch.utils import observability
    except ImportError:
        return None
    return getattr(observability, "TRACER", None)


def units(trace, kind: str):
    """The ids of the slice's units of `kind` (the last `trace.units` in
    the log that hold a span named `kind`), oldest first, or None."""
    t = tracer()
    if t is None or not trace.units:
        return None
    ids = []
    for rec in t.log:
        if rec[0] == "span" and rec[1] == kind and rec[2] is not None \
                and rec[2] not in ids[-1:]:
            ids.append(rec[2])
    return ids[-trace.units:] or None


def span_ms(trace, kind: str, name: str):
    """The host time in spans `name` per unit of `kind` in the slice, in
    ms."""
    ids = units(trace, kind)
    if ids is None:
        return None
    keep = set(ids)
    total = sum(r[4] - r[3] for r in tracer().log
                if r[0] == "span" and r[1] == name and r[2] in keep)
    return total / len(ids) / 1e6


def count_per_unit(trace, kind: str, name: str):
    """The counter `name` per unit of `kind` in the slice."""
    ids = units(trace, kind)
    if ids is None:
        return None
    keep = set(ids)
    return sum(r[3] for r in tracer().log
               if r[0] == "count" and r[1] == name and r[2] in keep) \
        / len(ids)
