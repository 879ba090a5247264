"""Everything the harness runs is found by name under a root directory (the
checkout, or a test's temporary directory), so that a cell, a traffic mix,
a driver loop, an intake, a scan pattern or a per-layer metric is added by
adding files and `BENCHMARK.json` entries, never by editing one:

  BENCHMARK.json                        the cells, configurations, metrics
  <config's "file">                     a configuration (benchmark/configs/)
  benchmark/traffic/<traffic>.json      a traffic mix: the names of its
                                        loop, feed and scan, and its sizes
  benchmark/cells/<cell>.json           a cell's limits for `correct`
  benchmark/loops/<loop>.py             a driver loop: `Loop` (loopkit.py)
  benchmark/feeds/<feed>.py             how the program receives a frame:
                                        `Feed`
  benchmark/scans/<scan>.py             a scan pattern: `pattern(...)`
                                        (frames.py)
  benchmark/metrics/<metric>.py         a per-layer metric's reader:
                                        `read(trace)`, optionally `NEEDS`
  benchmark/work/<work>.py              what a reader `NEEDS` counted by
                                        the reference: `count(...)`
                                        (check.kernel_work)
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

PACKAGE = "benchmark"


def _read(path: str):
    with open(path) as f:
        return json.load(f)


def _floats(tree):
    """The configuration files write infinities as "inf" / "-inf"."""
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_floats(v) for v in tree]
    if tree in ("inf", "-inf"):
        return float(tree)
    return tree


@dataclasses.dataclass
class Cell:
    name: str
    config: dict        # the configuration file, pipeline infinities parsed
    traffic: dict       # the traffic file
    limits: dict        # number -> limit
    chips: int
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list


class Benchmark:
    def __init__(self, root: str):
        self.root = root
        self.spec = _read(os.path.join(root, "BENCHMARK.json"))

    def path(self, *parts) -> str:
        return os.path.join(self.root, *parts)

    def cell(self, name: str) -> Cell:
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = by_name[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        config = _read(self.path(conf["file"]))
        config["pipeline"] = _floats(config["pipeline"])
        traffic = _read(self.path(PACKAGE, "traffic", w["traffic"] + ".json"))
        limits = _read(self.path(PACKAGE, "cells", name + ".json"))["limits"]
        reports = lambda m: name in m.get("workloads", [name])
        e2e = [m for m in self.spec["end_to_end"] if reports(m)]
        names = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if reports(m) and m["moves"] in names]
        return Cell(name=name, config=config, traffic=traffic,
                    limits=limits, chips=int(w["chips"]), end_to_end=e2e,
                    per_layer=per_layer)

    def plugin(self, kind: str, name: str):
        """The module `benchmark/<kind>/<name>.py` under the root, loaded
        from its own file (each load a fresh module)."""
        path = self.path(PACKAGE, kind, name + ".py")
        if not os.path.isfile(path):
            raise KeyError(f"no {kind} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"{PACKAGE}_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The metric's reader module: `read(trace) -> float | None`, and
        optionally `NEEDS`, the names of the `work` it reads."""
        return self.plugin("metrics", metric)
