"""Organized depth clouds through the port: the deployment
`anymal_d435x4_8m` (benchmark/configs/) at a small size on the CPU, four
cameras of 64 x 48 pixels in turn on a 64 x 64 map at 0.04 m, a dozen
frames made by the benchmark's own generator (scan pattern `d435`, feed
`depth_frame`).

  * The port's `ElevationPipeline`, handed each organized cloud as the
    camera gives it (every lane valid, NaN where a pixel has no depth),
    equals the plain reference (benchmark/reference/) handed the cloud as
    upstream's `cleanPointCloud` leaves it (NaN points removed, padded):
    every leaf bitwise, as the flagship's reference test holds it.
  * On the port alone, a frame with its NaN lanes equals the same frame
    with them removed, every leaf bitwise, and no NaN reaches the state;
    a stored keyframe scan keeps no NaN row.
  * A laser model in the structured-light model's place, or one camera's
    extrinsic left at the identity, is caught by the cell's limits.
"""

import dataclasses
import json
import os

import pytest
import torch

from benchmark import check, frames, registry
from benchmark.reference import config as r_config
from benchmark.reference import organized as r_organized
from benchmark.reference import pipeline as r_pipeline
from gem_tpu_torch.config import config_from_dict
from gem_tpu_torch.mapping.pipeline import (ElevationPipeline, Frame,
                                            init_pipeline_state, step)
from gem_tpu_torch.sensors.catalog import sensor_preset
from gem_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "anymal_d435x4_8m.online"
W, H = 64, 48
N_FRAMES = 12
SEED = 2 ** 31 + 2020


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


def _pipeline_dict():
    """The configuration file's pipeline block at the small size."""
    bench = registry.Benchmark(REPO)
    p = bench.cell(CELL).config["pipeline"]
    p["map"]["length"] = 64
    p["max_points"] = W * H
    p["raytrace_every"] = 4
    p["submap"].update(max_submaps=4, capacity=2048, staging_frames=4)
    return p


def _traffic():
    t = _read("benchmark", "traffic", "depth_online.json")
    t.update(points=W * H, width=W, height=H, circuit_frames=48,
             speed_m_per_frame=0.05)
    return t


def _feed(pipeline):
    bench = registry.Benchmark(REPO)
    t = _traffic()
    scans = frames.make_scans(t, SEED, "cpu",
                              bench.plugin("scans", t["scan"]).pattern)
    cfg = config_from_dict(pipeline)
    rcfg = r_config.config_from_dict(pipeline)
    return bench.plugin("feeds", t["feed"]).Feed(cfg, rcfg, t, scans,
                                                 "cpu"), cfg, rcfg


@pytest.fixture(scope="module")
def feed():
    return _feed(_pipeline_dict())


def _limits():
    return _read("benchmark", "cells", CELL + ".json")["limits"]


def _against_reference(cfg, rcfg, feed, frame_of=None):
    """The largest of each number over the frames: the port's pipeline on
    the feed's frames (through `frame_of`) against the reference on the
    cleaned ones."""
    pipe = ElevationPipeline(cfg, device="cpu")
    ref = r_pipeline.init_pipeline_state(rcfg, "cpu")
    numbers = {}
    for g in range(N_FRAMES):
        f = feed.host_frame(g)
        out = pipe.process(frame_of(g, f) if frame_of else f)
        ref, r_out = r_pipeline.step(ref, feed.reference_frame(g), rcfg)
        check.merge(numbers, check.frame_numbers(ref, r_out, pipe.state,
                                                 out, cfg))
    return numbers, pipe


def test_the_configuration_is_the_d435_preset(feed):
    _, cfg, _ = feed
    assert cfg.sensor == sensor_preset("realsense_d435")
    assert cfg.body_filter.mode == "none"
    assert cfg.map.resolution == 0.04


def test_organized_frames_equal_the_reference_on_cleaned_frames(feed):
    f, cfg, rcfg = feed
    holes = torch.isnan(f.points[:N_FRAMES, :, 0]).float().mean()
    assert 0.1 <= float(holes) < 0.5
    numbers, pipe = _against_reference(cfg, rcfg, f)
    assert all(v == 0 for v in numbers.values()), numbers
    assert set(numbers) == set(_limits())
    elev = pipe.state.map.elevation
    assert int((elev != cfg.map.invalid_elevation).sum()) > 500
    assert int(pipe.last_outputs.metrics["points_valid"]) > 0


def _cleaned(frame: Frame) -> Frame:
    """The frame with its NaN lanes removed in order and invalid zero lanes
    padded on: upstream's intake, as the reference takes it."""
    points, intensity, valid = r_organized.clean(
        frame.points, frame.intensity, frame.points.shape[0])
    return dataclasses.replace(frame, points=points, intensity=intensity,
                               valid=valid)


def _no_nan(tree) -> list:
    return [k for k, t in tree_leaves(tree).items()
            if t.is_floating_point() and bool(torch.isnan(t).any())]


def test_nan_lanes_equal_the_frame_without_them(feed):
    f, cfg, _ = feed
    state = init_pipeline_state(cfg, "cpu")
    state_c = init_pipeline_state(cfg, "cpu")
    for g in range(N_FRAMES):
        frame = f.host_frame(g)
        assert bool(torch.isnan(frame.points).any()) and bool(
            frame.valid.all())
        state, out = step(state, frame, cfg)
        state_c, out_c = step(state_c, _cleaned(frame), cfg)
        for a, b in ((state, state_c), (out, out_c)):
            la, lb = tree_leaves(a), tree_leaves(b)
            assert [k for k in la if not torch.equal(la[k], lb[k])] == [], g
        assert _no_nan(state) == [] and _no_nan(out) == [], g
    assert int(out.metrics["points_valid"]) == int(
        out_c.metrics["points_valid"]) > 0


def test_device_frame_is_the_host_frame(feed):
    """The frame the feed hands the program (`device_frame`) is the host
    frame leaf by leaf; what no frame changes is the same tensor in every
    frame of a camera, and there is no loop-closure leaf."""
    f, _, _ = feed
    for g in range(N_FRAMES):
        d, h = f.device_frame(g), f.host_frame(g)
        ld, lh = tree_leaves(d), tree_leaves(h)
        assert list(ld) == list(lh) and d.loop_closure is None
        for k in ld:
            torch.testing.assert_close(ld[k], lh[k], rtol=0, atol=0,
                                       equal_nan=True, msg=k)
        same = f.device_frame(g + f.cameras)
        for k in ("valid", "colors", "r_base_sensor", "t_base_sensor",
                  "r_map_base", "pose_quat", "pose_cov"):
            assert getattr(same, k) is getattr(d, k), k
        assert not torch.equal(same.transform, d.transform)


def test_a_keyframe_scan_keeps_no_nan_row(feed):
    """With keyframe scans on, the first keyframe's stored scan holds the
    finite lanes of its subsample only."""
    p = _pipeline_dict()
    p["submap"].update(keyframe_scan_points=512, keyframe_distance=0.1)
    f, cfg, _ = _feed(p)
    state = init_pipeline_state(cfg, "cpu")
    for g in range(6):
        state, out = step(state, f.host_frame(g), cfg)
    counts = state.submaps.kf_counts
    assert int(state.submaps.num_submaps) >= 1 and int(counts.max()) > 0
    assert not bool(torch.isnan(state.submaps.kf_points).any())
    assert int(counts.max()) < 512


def _caught(numbers) -> bool:
    ok, _ = check.judge(numbers, _limits())
    return not ok


def test_a_laser_model_is_caught(feed):
    f, _, rcfg = feed
    p = _pipeline_dict()
    p["sensor"] = dict(p["sensor"], model="laser")
    numbers, _ = _against_reference(config_from_dict(p), rcfg, f)
    assert _caught(numbers), numbers


def test_one_camera_at_the_identity_is_caught(feed):
    f, cfg, rcfg = feed

    def identity_for_camera_1(g, frame):
        if g % f.cameras != 1:
            return frame
        T = frame.transform.clone()
        T[:3, :3] = torch.eye(3)
        return dataclasses.replace(frame, transform=T,
                                   r_base_sensor=torch.eye(3))

    numbers, _ = _against_reference(cfg, rcfg, f, identity_for_camera_1)
    assert _caught(numbers), numbers
