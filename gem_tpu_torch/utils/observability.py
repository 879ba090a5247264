"""Tracing, metrics and structured logging.

Counterpart of gem_tpu/utils/observability.py:

  * PhaseTimer: per-phase wall times, synchronizing the device of the
    phase's output at exit, for coarse breakdowns.
  * trace(dir): a torch.profiler trace (CPU + CUDA activity) written as a
    Chrome trace into `dir`; a no-op when `dir` is empty.
  * MetricsLogger: an append-only JSONL stream, one dict per frame.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from gem_tpu_torch.utils.tree import tree_leaves


class PhaseTimer:
    """Accumulates {phase: seconds}; `with timer.phase("fuse", sync=out):`
    waits at exit for the CUDA devices that hold `sync` (a tensor or a tree
    of tensors); CPU and other tensors need no wait.

    NOTE: only the EXIT is synchronized: with asynchronous launches, device
    work still in flight from earlier phases is billed to the current one.
    For honest per-phase attribution, sync before entering (e.g. on the
    previous phase's output), or time whole programs instead."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 6),
                    "mean_ms": round(v / self.counts[k] * 1e3, 3),
                    "count": self.counts[k]}
                for k, v in self.totals.items()}


def _synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of `tree`."""
    for d in _cuda_devices(tree, set()):
        torch.cuda.synchronize(d)


def _cuda_devices(x, found: set) -> set:
    """The CUDA devices of the tensors in `x`: a tensor, or a state
    dataclass, dict, list or tuple of them; other leaves hold none."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _cuda_devices(y, found)
    elif isinstance(x, dict) or dataclasses.is_dataclass(x):
        for y in tree_leaves(x).values():
            _cuda_devices(y, found)
    return found


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace into `log_dir/trace.json` when set."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
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
