"""What a traced run (`--trace 1`) records and how it is reduced.

  * Host spans: the harness times its own calls into the program (`intake`,
    `enqueue`, `sync`, `restitch`, ...) with the host clock, kept in memory
    per unit (frame or event) over the whole window.
  * A profiled slice: a fixed number of consecutive units of the window run
    under torch.profiler (CPU and CUDA activity).  Its device events
    (kernels, copies, fills: the CUDA activity) and the harness's own spans
    (`record_function`, on the profiler's clock) are kept in memory; no
    trace file is written.

`Trace` is what each per-layer metric's reader (benchmark/metrics/) reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

SLICE = "benchmark_slice"


@dataclasses.dataclass
class Trace:
    spans: dict                 # name -> [seconds] over the window's units
    device: list                # [(name, start us, end us)] in the slice
    host: list                  # [(name, start us, end us)] in the slice
    slice_us: tuple             # (start us, end us) of the slice
    units: int                  # frames or events in the slice
    work: list | None = None    # kernel work per slice frame (check.py)

    @property
    def window_s(self) -> float:
        return (self.slice_us[1] - self.slice_us[0]) / 1e6

    def busy_us(self) -> float:
        """The union of the device events' time within the slice."""
        lo, hi = self.slice_us
        busy, end = 0.0, lo
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        return busy

    def within(self, span: str) -> tuple[float, float]:
        """(union of device time inside the host spans named `span`, their
        total length), in us: device work that those spans waited for."""
        busy = total = 0.0
        for name, lo, hi in self.host:
            if name != span:
                continue
            total += hi - lo
            end = lo
            for _, a, b in sorted(self.device, key=lambda e: e[1]):
                a, b = max(a, end), min(b, hi)
                if b > a:
                    busy += b - a
                    end = b
        return busy, total

    def kernel_us(self, symbol: str) -> list:
        return [b - a for n, a, b in self.device if symbol in n]

    def gaps(self) -> list:
        """[(start us, length us)] of the slice's idle stretches."""
        lo, hi = self.slice_us
        out, end = [], lo
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if a > end:
                out.append((end, a - end))
            end = max(end, b)
        if hi > end:
            out.append((end, hi - end))
        return out

    def host_span_at(self, t: float) -> str:
        """The innermost harness span the host was in at time t (a gap is
        named by its middle)."""
        best = None
        for name, a, b in self.host:
            if a <= t < b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "between_spans"

    def breakdown(self, top: int = 10) -> dict:
        total = defaultdict(float)
        for n, a, b in self.device:
            total[n] += (b - a) / 1e6
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.host_span_at(a + g / 2), g / 1e6]
                              for a, g in gaps]}


class Recorder:
    """Host spans for the whole window, and the profiler over one slice."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.spans = defaultdict(list)   # every span name a loop used
        self.prof = None
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def slice(self):
        """Profile the block (a fixed number of units).  The device is
        synchronised on entry and exit, outside the slice."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.profiling = True
        try:
            with torch.profiler.record_function(SLICE):
                yield
                if self.cuda:
                    torch.cuda.synchronize()
        finally:
            self.profiling = False
            self.prof.stop()

    def trace(self, units: int) -> Trace:
        """The slice reduced to a `Trace` (call after the window)."""
        device, host, slice_us = [], [], None
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.name in self.spans or e.name == SLICE:
                # the harness's spans; on the card each also shows as a
                # device-side annotation, which is no device work
                if e.device_type == torch.autograd.DeviceType.CPU:
                    if e.name == SLICE:
                        slice_us = (a, b)
                    else:
                        host.append((e.name, a, b))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                device.append((e.name, a, b))
        if slice_us is None:
            raise RuntimeError("the profiled slice left no span")
        return Trace(spans=dict(self.spans), device=device, host=host,
                     slice_us=slice_us, units=units)


def mean_ms(trace: Trace, span: str):
    """The mean host-clock length of a harness span, in ms."""
    v = trace.spans.get(span)
    return sum(v) / len(v) * 1e3 if v else None


def idle_percent(trace: Trace, span: str | None = None):
    """The share of the slice (or of the host spans named `span`) in which
    no operation ran on the device, in %."""
    if span is None:
        busy, total = trace.busy_us(), trace.slice_us[1] - trace.slice_us[0]
    else:
        busy, total = trace.within(span)
    return 100.0 * (1.0 - busy / total) if total > 0 else None


def roofline_percent(trace: Trace, symbol: str, bound_ms):
    """The kernel's least time over its measured time, in %: the mean of
    the per-frame bounds over the mean launch, or None without a launch."""
    times = trace.kernel_us(symbol)
    if not times or not trace.work:
        return None
    bounds = [bound_ms(w) for w in trace.work]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times)
                                                  / 1e3)
