"""Tracing, metrics and structured logging.

  * TRACER: the port's own tracer, off by default: host spans, counters
    and device stage stamps at the boundaries of its layers (below).
  * trace(dir): a torch.profiler trace (CPU + CUDA activity) written as a
    Chrome trace into `dir`, with TRACER on for its block; a no-op when
    `dir` is empty.
  * MetricsLogger: an append-only JSONL stream, one dict per frame.

The tracer works in units: one `DeviceProgram` call (a frame, a scan, a
fleet frame) or one `apply_loop_closure` call.  A unit opens where the
first of them is entered and every span, count and mark inside it carries
its id; a unit entered inside another joins it.

  * `span(name)`: the host time of a block, named `gem.<layer>.<what>`, on
    the profiler's clock as a CPU operation of the profiler (no
    device-side annotation, so a profile's device events are the work
    alone), and kept as a call count and a host time per name.
  * `count(name, n)`: an integer counter.
  * `mark(stage, device)`: a device stamp.  On a card a one-thread kernel
    (csrc/graph_cond.cu, `gem_trace_stamp`) writes `%globaltimer` (ns)
    into `ring[row, column of stage]`, where `row` is a counter on the
    device that the unit's first mark advances: no host read, and it runs
    as it is in a replayed CUDA graph and inside an IF node's body.  A
    body that did not run leaves its slot older than its row's first
    stamp.  On the CPU the same layout holds `time.perf_counter_ns()`.
    Under a capture a mark never advances the row: `DeviceProgram` marks
    `program.in` eagerly before each replay.  Each device's ring is made
    at its first mark and kept for the process (captured graphs hold its
    address); `reset` zeroes it in place.

Spans and counters are kept while the tracer is on and while a
torch.profiler records; `log` keeps each of them, with its unit, only
while a profiler records (the profiled slice of a benchmark run).  Inside
`tally()` counts go to the block's own dict instead, whatever the tracer's
state: a CUDA graph's capture, whose counts `DeviceProgram` repeats on
each replay (`control.selects`, the select-routed branches).  Marks
stamp only while the tracer is on; a `DeviceProgram` drops its graphs and
captures again when the tracer is turned on or off, so its graphs hold
stamps exactly while it is on.  Off, and with no profiler, each call is
one or two flag checks: no device work, no graph node, nothing kept, no
ring allocated.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

# the ring's columns: the boundaries that the program stamps, in the order
# a frame reaches them ("flush" and "finalize" inside the IF bodies)
STAGES = ("program.in", "move", "pointproc", "fuse", "motion", "features",
          "shed", "flush", "raytrace", "keyframe", "finalize", "write_back",
          "program.out", "refuse", "refused")
COLUMN = {s: i for i, s in enumerate(STAGES)}
# each stage as the stretches between stamps it covers; "program_io" is the
# input copies and the graph's launch, then the write-back and the output
# copies; "submaps" the shed (with the flush body), then the keyframe
# finalize body
STAGE_STRETCHES = {
    "move": (("move", "pointproc"),),
    "pointproc": (("pointproc", "fuse"),),
    "fuse": (("fuse", "motion"),),
    "motion": (("motion", "features"),),
    "features": (("features", "shed"),),
    "raytrace": (("raytrace", "keyframe"),),
    "submaps": (("shed", "raytrace"), ("keyframe", "write_back")),
    "program_io": (("program.in", "move"), ("write_back", "program.out")),
    "refuse": (("refuse", "refused"),),
}
ROWS = 1 << 16

_profiling = torch._C._autograd._profiler_enabled


_NULL = contextlib.nullcontext()


class _Unit:
    __slots__ = ("tracer",)

    def __init__(self, tracer):
        self.tracer = tracer

    def __enter__(self):
        t = self.tracer
        t._unit = (t.units, {})          # (id, {device: (row, column)})
        t.units += 1

    def __exit__(self, *exc):
        self.tracer._unit = None


class _Span:
    __slots__ = ("tracer", "name", "op", "t0")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        # a CPU operation of the profiler; record_function would add a
        # device-side annotation over the kernels the block launches
        self.op = torch._C._profiler._RecordFunctionFast(self.name) \
            if _profiling() else None
        if self.op is not None:
            self.op.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.op is not None:
            self.op.__exit__(*exc)
        self.tracer._closed(self.name, self.t0, t1)


class Tracer:
    """The port's spans, counters and device stamps (see the module
    docstring).  `counts` {name: n}; `spans` {name: [calls, host ns]};
    `log` [("span", name, unit, t0 ns, t1 ns) | ("count", name, unit, n)],
    kept while a profiler records."""

    def __init__(self):
        self.on = False
        self._rings: dict = {}           # device -> (ring, row counter)
        self._tally: Optional[dict] = None
        self.reset()

    def reset(self) -> None:
        """Forget everything recorded; the rings are zeroed in place."""
        self.counts: dict[str, int] = {}
        self.spans: dict[str, list] = {}
        self.log: list = []
        for ring, counter in self._rings.values():
            ring.zero_()
            counter.zero_()
        self.advanced: dict = {}         # device -> rows advanced so far
        self.units = 0
        self._unit = None

    def enable(self, on: bool = True) -> None:
        self.on = on

    @contextlib.contextmanager
    def enabled(self):
        """On inside the block, as it was after."""
        was, self.on = self.on, True
        try:
            yield self
        finally:
            self.on = was

    # -- spans, counters, units ---------------------------------------------
    def unit(self):
        """Open a unit for the block, or join the open one."""
        if self._unit is not None or not (self.on or _profiling()):
            return _NULL
        return _Unit(self)

    def span(self, name: str):
        if not (self.on or _profiling()):
            return _NULL
        return _Span(self, name)

    def _unit_id(self):
        return None if self._unit is None else self._unit[0]

    def _closed(self, name: str, t0: int, t1: int) -> None:
        s = self.spans.setdefault(name, [0, 0])
        s[0] += 1
        s[1] += t1 - t0
        if _profiling():
            self.log.append(("span", name, self._unit_id(), t0, t1))

    def count(self, name: str, n: int = 1) -> None:
        if self._tally is not None:
            self._tally[name] = self._tally.get(name, 0) + n
            return
        if not (self.on or _profiling()):
            return
        self.counts[name] = self.counts.get(name, 0) + n
        if _profiling():
            self.log.append(("count", name, self._unit_id(), n))

    @contextlib.contextmanager
    def tally(self):
        """Count the block's counters into the dict it yields, and nowhere
        else, whether the tracer is on or off."""
        was, self._tally = self._tally, {}
        try:
            yield self._tally
        finally:
            self._tally = was

    # -- device stamps ------------------------------------------------------
    def mark(self, stage: str, device) -> None:
        """Stamp `stage` of the open unit on `device` (see the module
        docstring); nothing while off or outside a unit."""
        if not self.on or self._unit is None:
            return
        dev = device if isinstance(device, torch.device) \
            else torch.device(device)
        cuda = dev.type == "cuda"
        capturing = cuda and torch.cuda.is_current_stream_capturing()
        col = COLUMN[stage]
        ring, counter = self._ring(dev, capturing)
        rows = self._unit[1]
        advance = dev not in rows and not capturing
        if advance:
            n = self.advanced.get(dev, 0) + 1
            self.advanced[dev] = n
            rows[dev] = (n - 1) % ROWS
        if cuda:
            _stamp(torch._C._cuda_getCurrentRawStream(dev.index), ring,
                   counter, col, advance)
        else:
            # the host is the device: the row needs no counter
            ring[rows[dev], col] = time.perf_counter_ns()

    def _ring(self, dev, capturing: bool):
        got = self._rings.get(dev)
        if got is None:
            if capturing:
                raise RuntimeError("the tracer's ring is made outside a "
                                   "capture: mark once eagerly first")
            got = (torch.zeros((ROWS, len(STAGES)), dtype=torch.int64,
                               device=dev),
                   torch.zeros((1,), dtype=torch.int64, device=dev))
            self._rings[dev] = got
        return got

    def ring(self, device) -> Optional[np.ndarray]:
        """The stamps of `device` as a host (ROWS, len(STAGES)) array (a
        read: it waits for the device), or None before its first mark."""
        got = self._rings.get(torch.device(device))
        return None if got is None else got[0].cpu().numpy()

    def recent_rows(self, device, k: int) -> list:
        """The rows of the last `k` rows advanced on `device`, oldest
        first."""
        n = self.advanced.get(torch.device(device), 0)
        return [i % ROWS for i in range(max(n - k, 0), n)]


_STAMP = []     # (gem_trace_stamp, check) of the kernel library, at first use


def _stamp(stream: int, ring, counter, col: int, advance: bool) -> None:
    """Launch the stamp kernel (csrc/graph_cond.cu) on `stream`."""
    if not _STAMP:
        from gem_tpu_torch.kernels._build import check, library

        _STAMP.extend((library().gem_trace_stamp, check))
    fn, check = _STAMP
    check(fn(stream, ring.data_ptr(), counter.data_ptr(), ROWS,
             len(STAGES), col, int(advance)), "gem_trace_stamp")


def stage_ns(row: np.ndarray, first: str) -> dict:
    """{stage: ns} of one ring row whose unit's first mark was `first`:
    the stages of STAGE_STRETCHES whose stamps are all at or after it; a
    stage with a stale stamp (written by an older unit) is left out."""
    start = row[COLUMN[first]]
    out = {}
    for stage, stretches in STAGE_STRETCHES.items():
        total = 0
        for a, b in stretches:
            ta, tb = row[COLUMN[a]], row[COLUMN[b]]
            if ta < start or tb < ta:
                break
            total += int(tb - ta)
        else:
            out[stage] = total
    return out


def taken(row: np.ndarray, first: str, stage: str) -> bool:
    """Whether the stamp of `stage` (an IF body's) is this unit's own."""
    return bool(row[COLUMN[stage]] >= row[COLUMN[first]])


TRACER = Tracer()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace into `log_dir/trace.json` when set, with
    TRACER on inside it."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with TRACER.enabled(), profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def log(self, frame_idx: int, metrics: dict, **extra):
        if self._f is None:
            return
        rec = {"frame": int(frame_idx), "t": time.time(), **extra}
        for k, v in metrics.items():
            a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
            rec[k] = a.tolist() if a.ndim else a.item()
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
