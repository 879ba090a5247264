"""The depth-camera cell (`anymal_d435x4_8m.online`: four cameras' organized
clouds through `ElevationPipeline`) at a tiny size on the CPU, the
harness's look for a card skipped: sound and traced runs come out correct
with every depth reader reporting, and the control and each planted fault
come out not correct.

Faults: camera 1's extrinsic swapped for camera 3's in the program; the
structured-light depth cutoff left out of the program; the reference
handed each hole as a valid point 1 m down its camera's view axis instead
of removing it.  A hole handed over as a point at 0 is no fault the check
can see: depth 0 lies under the 0.2 m cutoff, so the reference drops it as
it drops a removed point."""

import dataclasses
import json
import os

import pytest
import torch

from benchmark import harness, registry, tracing, yardstick
from benchmark.reference import organized as r_organized
from benchmark.tests import tiny

CELL = "anymal_d435x4_8m.online"
SEED = 2 ** 31 + 2031
READERS = ("device_ms_per_frame.depth", "k1_roofline.depth",
           "bytes_in.depth")
W, H = 64, 48
L = 200


@pytest.fixture(scope="module")
def depth_root(tmp_path_factory):
    """The tiny root, with the depth traffic at 64 x 48 pixels filling the
    configuration's frames, on the configuration's own 8 m map: the
    cameras see ground to 3.7 m, past the tiny root's 2.56 m half-width."""
    root = tiny.make_root(str(tmp_path_factory.mktemp("depth")))
    bench = registry.Benchmark(root)
    w = [w for w in bench.spec["workloads"] if w["name"] == CELL][0]
    path = bench.path("benchmark", "traffic", w["traffic"] + ".json")
    with open(path) as f:
        t = json.load(f)
    t.update(points=W * H, width=W, height=H, max_range_m=10.0,
             speed_m_per_frame=0.05)
    with open(path, "w") as f:
        json.dump(t, f)
    conf_path = bench.path("benchmark", "configs", w["config"] + ".json")
    with open(conf_path) as f:
        conf = json.load(f)
    conf["pipeline"]["max_points"] = W * H
    conf["pipeline"]["map"]["length"] = L
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    return root


def _run(root, control=False, seed=SEED):
    return harness.run_cell(root, CELL, seed, 0.5, False, "cpu",
                            control=control)


def test_sound_run_is_correct(depth_root):
    out = _run(depth_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"frame_ms_p95", "setup_s"}


def test_traced_run_reports_the_depth_readers(depth_root, monkeypatch):
    """The CPU has no kernel events and copies no inputs, so the trace is
    given one K1 launch of 1 us per frame and `DeviceProgram` counts its
    inputs' bytes as a replay on the card does."""
    from gem_tpu_torch.utils import graph
    from gem_tpu_torch.utils.observability import TRACER
    from gem_tpu_torch.utils.tree import tree_leaves

    traces = []
    real_trace = tracing.Recorder.trace

    def trace(self, units):
        t = real_trace(self, units)
        lo = t.slice_us[0]
        t.device += [(yardstick.K1_SYMBOL, lo + u, lo + u + 1.0)
                     for u in range(units)]
        traces.append(t)
        return t

    real_call = graph.DeviceProgram._call
    sizes = []

    def call(self, fn, inputs):
        n = sum(t.nbytes for t in tree_leaves(inputs).values())
        sizes.append(n)
        TRACER.count("program.bytes_in", n)
        return real_call(self, fn, inputs)

    monkeypatch.setattr(tracing.Recorder, "trace", trace)
    monkeypatch.setattr(graph.DeviceProgram, "_call", call)
    out = harness.run_cell(depth_root, CELL, SEED + 1, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(READERS) <= set(got), got
    assert got["k1_roofline.depth"]["value"] > 0
    assert got["device_ms_per_frame.depth"]["value"] > 0
    # points, intensity, valid, colors and the small leaves
    assert len(set(sizes)) == 1
    assert got["bytes_in.depth"]["value"] == sizes[0] / 1e6
    assert sizes[0] > W * H * (12 + 4 + 1 + 4)
    (t,) = traces
    assert len(t.work) == t.units
    assert all(w["k1"][0] == L * L for w in t.work)


def test_control_is_not_correct(depth_root):
    assert not _run(depth_root, control=True)["correct"]


def _camera_rotations():
    bench = registry.Benchmark(tiny.REPO)
    with open(bench.path("benchmark", "traffic", "depth_online.json")) as f:
        t = json.load(f)
    return bench.plugin("scans", "d435").rotations(t).to(torch.float32)


def _camera_swapped(monkeypatch):
    """Camera 1's clouds fused under camera 3's extrinsic."""
    from gem_tpu_torch.mapping import pipeline

    rots = _camera_rotations()
    real = pipeline.step

    def step(state, frame, cfg, fuse_backend="stream"):
        if torch.equal(frame.r_base_sensor, rots[1]):
            T = frame.transform.clone()
            T[:3, :3] = rots[3]
            frame = dataclasses.replace(frame, transform=T,
                                        r_base_sensor=rots[3].clone())
        return real(state, frame, cfg, fuse_backend)

    monkeypatch.setattr(pipeline, "step", step)


def _cutoff_left_out(monkeypatch):
    from gem_tpu_torch.mapping import pipeline

    real = pipeline.process_points

    def process_points(state, cfg, *args, **kw):
        sensor = dataclasses.replace(cfg.sensor,
                                     cutoff_min_depth=float("-inf"),
                                     cutoff_max_depth=float("inf"))
        return real(state, dataclasses.replace(cfg, sensor=sensor), *args,
                    **kw)

    monkeypatch.setattr(pipeline, "process_points", process_points)


def _holes_at(depth):
    """The reference's intake with every hole kept as a valid point
    `depth` down its camera's view axis."""
    def install(monkeypatch):
        def clean(points, intensity, max_points):
            hole = ~torch.isfinite(points).all(dim=-1, keepdim=True)
            at = torch.tensor([0.0, 0.0, depth], dtype=points.dtype,
                              device=points.device)
            filled = torch.where(hole, at, points)
            valid = torch.ones(max_points, dtype=torch.bool,
                               device=points.device)
            return filled, intensity, valid

        monkeypatch.setattr(r_organized, "clean", clean)
    return install


@pytest.mark.parametrize("fault", [_camera_swapped, _cutoff_left_out,
                                   _holes_at(1.0)],
                         ids=["camera_swapped", "cutoff_left_out",
                              "holes_at_1m"])
def test_fault_is_caught(depth_root, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(depth_root)["correct"]


def test_holes_at_zero_fall_under_the_cutoff(depth_root, monkeypatch):
    _holes_at(0.0)(monkeypatch)
    assert _run(depth_root)["correct"]
