"""Tracing, metrics and structured logging.

Counterpart of gem_tpu/utils/observability.py:

  * trace(dir): a torch.profiler trace (CPU + CUDA activity) written as a
    Chrome trace into `dir`; a no-op when `dir` is empty.
  * MetricsLogger: an append-only JSONL stream, one dict per frame.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch


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
