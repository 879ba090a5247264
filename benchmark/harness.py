"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

`run_cell` takes the device as an argument so that the harness's tests can
drive it on the CPU at a tiny size; `benchmark/run.py`, the command, looks
for the card first and never falls back to the CPU.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark import check, registry, tracing
from benchmark.reference import config as r_config

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gem_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_configs(cell):
    """(the program's PipelineConfig, the reference's) from one file."""
    from gem_tpu_torch.config import config_from_dict

    pipeline = cell.config["pipeline"]
    return config_from_dict(pipeline), r_config.config_from_dict(pipeline)


def _number(v):
    return None if v is None else float(v)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float | None = None,
             control: bool = False) -> dict:
    """The run's result (the contract's keys, then `checks`).  With
    `control` the reference in TF32 takes the program's place in the
    comparison (benchmark/control.py); the run is otherwise the same."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = registry.Benchmark(root)
    cell = bench.cell(name)
    cfg, rcfg = build_configs(cell)
    device = torch.device(device)
    cuda = device.type == "cuda"
    rec = tracing.Recorder(trace, device)
    readers = {m["name"]: bench.reader(m["name"]) for m in cell.per_layer}
    loop = bench.plugin("loops", cell.traffic["loop"]).Loop(
        bench, cell, cfg, rcfg, seed, device, rec)
    if trace:
        for r in readers.values():
            for w in getattr(r, "NEEDS", ()):
                loop.work.setdefault(w, bench.plugin("work", w))
    loop.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s:.3f}s since start: {loop.phases.line()}",
          file=sys.stderr)

    measured = loop.window(seconds)
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"modules loaded in the measured process: {loaded}")

    result = {}
    attempted = loop.attempted
    if trace:
        traced = rec.trace(loop.trace_units)
        if loop.work:
            traced.work = loop.kernel_work()
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(traced)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        busy = traced.busy_us() / 1e6
        dev_extra = {"busy_s": busy, "window_s": traced.window_s}
        result["breakdown"] = traced.breakdown()
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": float(measured[m["name"]]),
                                      "unit": m["unit"]}
        dev_extra = {}

    loop.release()
    gc.collect()
    failed = 0
    try:
        numbers = loop.check(control=control)
    except RuntimeError as e:
        print(f"check: {e}", file=sys.stderr)
        numbers, failed = {}, attempted
    ok, rows = check.judge(numbers, cell.limits)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak), **dev_extra}
    out = {"correct": bool(ok), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    out.update(result)
    out["checks"] = {n: {"value": _number(v), "limit": _number(lim)}
                     for n, v, lim in rows}
    return out
