"""The reference (a frozen copy of the port's plain path, importing nothing
of it) agrees with the port at a tiny size on the CPU, and its control
(TF32 contractions, float32 voxel sums) does not."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, frames, registry
from benchmark.reference import config as r_config
from benchmark.reference import intake as r_intake
from benchmark.reference import loop_closure as r_loop
from benchmark.reference import pipeline as r_pipeline
from benchmark.reference import precision as r_precision
from benchmark.tests.tiny import REPO
from gem_tpu_torch import native
from gem_tpu_torch.config import benchmark_config, kitti_config
from gem_tpu_torch.global_map.loop_closure import apply_loop_closure
from gem_tpu_torch.io.replay import synthetic_frames
from gem_tpu_torch.mapping.pipeline import init_pipeline_state, step


def _tiny(raytrace_every=1):
    base = benchmark_config(length=128, max_points=4096,
                            raytrace_every=raytrace_every)
    return base.replace(submap=dataclasses.replace(
        base.submap, max_submaps=4, capacity=2048, keyframe_distance=2.0,
        overlap_radius=6.0, staging_frames=4))


def _run(cfg, n, control=False):
    rcfg = r_config.config_from_dict(dataclasses.asdict(cfg))
    s = init_pipeline_state(cfg, "cpu")
    rs = r_pipeline.init_pipeline_state(rcfg, "cpu")
    r_precision.TF32 = control
    try:
        for f, _, _ in synthetic_frames(cfg, n, n_points=4096, speed=0.5,
                                        device="cpu"):
            rf = check.to_reference(f, "cpu")
            s, o = step(s, f, cfg)
            rs, ro = r_pipeline.step(rs, rf, rcfg)
    finally:
        r_precision.TF32 = False
    return check.frame_numbers(rs, ro, s, o, cfg), s, rs, rcfg


@pytest.mark.parametrize("every", [1, 3])
def test_step_agrees_bitwise(every):
    numbers, s, _, _ = _run(_tiny(every), 14)
    assert int(s.submaps.num_submaps) >= 2
    assert all(v == 0 for v in numbers.values()), numbers


def test_step_control_differs():
    numbers, _, _, _ = _run(_tiny(), 6, control=True)
    assert numbers["elevation_gap_m"] > 1e-3
    assert numbers["int_mismatch"] > 0


def test_loop_closure_agrees_bitwise():
    cfg = _tiny()
    _, s, rs, rcfg = _run(cfg, 30)
    k = int(s.submaps.num_submaps)
    opt = s.submaps.poses.numpy()[:min(k, 4)].copy()
    opt[:, :3] += np.linspace(0, 1, len(opt))[:, None] * [0.5, -0.3, 0.05]
    store, stats = apply_loop_closure(s.submaps, cfg, opt)
    rstore, rstats = r_loop.apply_loop_closure(rs.submaps, rcfg, opt)
    assert stats["n_pairs"] > 0
    numbers = check.restitch_numbers(rstore, rstats, store, stats, cfg)
    assert all(v == 0 for v in numbers.values()), numbers
    r_precision.TF32 = True
    try:
        cstore, cstats = r_loop.apply_loop_closure(rs.submaps, rcfg, opt)
    finally:
        r_precision.TF32 = False
    bad = check.restitch_numbers(rstore, rstats, cstore, cstats, cfg)
    assert bad["restitch_gap_m"] > 1e-4


def test_voxel_filter_is_the_host_runtimes_as_a_set():
    hdl64 = registry.Benchmark(REPO).plugin("scans", "hdl64").pattern
    scans = frames.make_scans(
        {"scan": "hdl64", "points": 64 * 200, "max_range_m": 80.0,
         "sensor_height_m": 1.73, "noise_m": 0.01, "circuit_frames": 2,
         "speed_m_per_frame": 1.0}, 5, "cpu", hdl64)
    pts, inten = scans.points[0].numpy(), scans.intensity[0].numpy()
    crop = ((-40.0, 40.0), (-40.0, 40.0), (-25.0, 25.0))
    a, ai = native.voxel_filter(pts, inten, leaf=0.2, crop=crop)
    b, bi = r_intake.voxel_filter(pts, inten, 0.2, crop)
    key = lambda p, i: np.lexsort((i, p[:, 2], p[:, 1], p[:, 0]))
    ka, kb = key(a, ai), key(b, bi)
    assert np.array_equal(a[ka], b[kb]) and np.array_equal(ai[ka], bi[kb])


def test_pad_frame_agrees_with_the_ports():
    from gem_tpu_torch.io.replay import pad_frame

    cfg = kitti_config(max_points=4096)
    rcfg = r_config.config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    pts = (rng.standard_normal((3000, 3)) * [10, 10, 1]).astype(np.float32)
    inten = rng.uniform(1, 100, 3000).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1.0, 2.0, 1.7]
    track = np.asarray([1.0, 2.0, 0.0], np.float32)
    f = pad_frame(cfg, pts, inten, transform=T, track_position=track,
                  device="cpu")
    rf = r_intake.pad_frame(rcfg, pts, inten, T, track, "cpu")
    assert check.intake_gap(rf, f) == 0.0
    for k in ("transform", "track_position", "t_map_base", "pose_cov",
              "colors", "loop_closure"):
        assert torch.equal(getattr(f, k), getattr(rf, k)), k
