"""BENCHMARK.json against the benchmark's contract, and every file that a
cell names found by that name."""

import json
import os
import re

import pytest

from benchmark import harness, loopkit, registry
from benchmark.tests import tiny
from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(s["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in s["paths"])
    assert len(s["command"]) <= 32 and all(_line(w) for w in s["command"])
    assert 1 <= s["run_seconds"] <= 51
    names = []
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(s["paths"]))
        names.append(c["name"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in names
        names.append(w["name"])
    assert sum(w["chips"] == 4 for w in s["workloads"]) \
        <= max(1, len(s["workloads"]) // 4)
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in s["end_to_end"]}
    assert len(json.dumps(s)) <= 64 * 1024


def _reports(m, cell):
    return cell in m.get("workloads", [cell])


def test_every_cell_reports_what_its_metrics_move():
    s = spec()
    cells = [w["name"] for w in s["workloads"]]
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(e2e[m["moves"]], cell)
    for cell in cells:
        reported = [n for n, m in e2e.items() if _reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(_reports(m, cell) for m in s["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_files_found_by_name(cell):
    b = registry.Benchmark(REPO)
    c = b.cell(cell)
    assert c.config["name"] == [w for w in spec()["workloads"]
                                if w["name"] == cell][0]["config"]
    assert issubclass(b.plugin("loops", c.traffic["loop"]).Loop,
                      loopkit.FrameLoop)
    assert issubclass(b.plugin("feeds", c.traffic["feed"]).Feed,
                      loopkit.FeedBase)
    assert callable(b.plugin("scans", c.traffic["scan"]).pattern)
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for m in c.per_layer:
        reader = b.reader(m["name"])
        assert callable(reader.read)
        for w in getattr(reader, "NEEDS", ()):
            assert callable(b.plugin("work", w).count)


def test_a_missing_plugin_is_named():
    with pytest.raises(KeyError, match="no loops named 'nowhere'"):
        registry.Benchmark(REPO).plugin("loops", "nowhere")


def test_config_files_hold_their_keys():
    for c in spec()["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["assumed"] and conf["guarantees"] and conf["pipeline"]


LOOP = """
import time

import numpy as np

from benchmark import loopkit


class Loop(loopkit.FrameLoop):
    def window(self, seconds):
        times, t_start = [], time.perf_counter()
        while True:
            t0 = time.perf_counter()
            for _ in range(int(self.traffic["burst"])):
                g = self.k
                self._before(g)
                f, out = self.frame()
                self._after(g, f, out)
                self.k += 1
            loopkit.sync(self.device)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if t1 - t_start >= seconds and not self._pending():
                break
        self.attempted = len(times)
        return {"burst_ms_p95": float(np.percentile(times, 95)) * 1e3}
"""
FEED = """
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "frame_feed", os.path.join(os.path.dirname(__file__), "frame.py"))
_frame = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_frame)


class Feed(_frame.Feed):
    pass
"""
SCAN = """
import math

import torch


def pattern(traffic, gen, m, n, dev):
    f64 = dict(generator=gen, device=dev, dtype=torch.float64)
    r = float(traffic["max_range_m"]) * torch.rand((m, n), **f64).sqrt()
    az = 2 * math.pi * torch.rand((m, n), **f64)
    return r * torch.cos(az), r * torch.sin(az), None
"""
WORK = """
def count(kind, args, rcfg):
    if kind == "fuse_stream_aggregate":
        offsets = args[0]
        return int((offsets[..., -1] - offsets[..., 0]).sum())
    return None
"""
READER = """
NEEDS = ("in_cells",)


def read(trace):
    if not trace.work:
        return None
    return sum(w["in_cells"] for w in trace.work) / len(trace.work)
"""


def test_a_new_cell_is_only_new_files(tmp_path):
    """A configuration, a traffic mix with a driver loop, a feed and a scan
    pattern of its own, an end-to-end metric, a per-layer metric with the
    work it needs, and a cell: added as new files and BENCHMARK.json
    entries in a throwaway root, found by name and run whole on the CPU at
    a tiny size."""
    root = tiny.make_root(str(tmp_path))
    root_path = tmp_path
    write = lambda rel, text: (root_path / rel).write_text(text)
    s = json.load(open(root_path / "BENCHMARK.json"))
    conf = json.load(open(root_path / s["configs"][0]["file"]))
    conf["name"] = "extra_cfg"
    write("benchmark/configs/extra_cfg.json", json.dumps(conf))
    traffic = json.load(open(root_path / "benchmark/traffic/online.json"))
    traffic.update(loop="bursts", feed="frame_copy", scan="disc", burst=3)
    write("benchmark/traffic/extra_mix.json", json.dumps(traffic))
    write("benchmark/cells/extra_cfg.extra_mix.json", open(
        root_path / "benchmark/cells/hdl64_100m.online.json").read())
    write("benchmark/loops/bursts.py", LOOP)
    write("benchmark/feeds/frame_copy.py", FEED)
    write("benchmark/scans/disc.py", SCAN)
    write("benchmark/work/in_cells.py", WORK)
    write("benchmark/metrics/points_in_cells.burst.py", READER)
    cell = "extra_cfg.extra_mix"
    s["configs"].append({"name": "extra_cfg", "source": "a test",
                         "file": "benchmark/configs/extra_cfg.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": cell, "config": "extra_cfg",
                           "traffic": "extra_mix", "chips": 1,
                           "why": "a test"})
    s["end_to_end"].append({"name": "burst_ms_p95", "unit": "ms",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock", "workloads": [cell]})
    s["per_layer"].append({"name": "points_in_cells.burst",
                           "unit": "count", "better": "higher",
                           "source": "device_trace", "layer": "kernels",
                           "moves": "burst_ms_p95", "workloads": [cell]})
    write("BENCHMARK.json", json.dumps(s))

    c = registry.Benchmark(root).cell(cell)
    assert c.traffic["loop"] == "bursts" and c.config["name"] == "extra_cfg"
    assert [m["name"] for m in c.per_layer] == ["points_in_cells.burst"]
    out = harness.run_cell(root, cell, 2 ** 31 + 5, 1.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"burst_ms_p95", "setup_s"}
    traced = harness.run_cell(root, cell, 2 ** 31 + 6, 1.0, True, "cpu")
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["points_in_cells.burst"]["value"] > 0
