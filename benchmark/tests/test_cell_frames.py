"""The traffic generator repeats for a seed, differs across seeds and
gives every seed the same sizes."""

import numpy as np
import pytest
import torch

from benchmark import frames, loopkit, registry
from benchmark.tests.tiny import REPO

RING = {"scan": "ring", "points": 512, "min_range_m": 2.0,
        "max_range_m": 45.0, "sensor_height_m": 1.8, "noise_m": 0.01,
        "circuit_frames": 16, "speed_m_per_frame": 1.0}
HDL64 = dict(RING, scan="hdl64", points=64 * 30, max_range_m=80.0)


def scans(traffic, seed):
    pattern = registry.Benchmark(REPO).plugin("scans", traffic["scan"])
    return frames.make_scans(traffic, seed, "cpu", pattern.pattern)


@pytest.mark.parametrize("traffic", [RING, HDL64], ids=["ring", "hdl64"])
def test_repeats_and_differs(traffic):
    a = scans(traffic, 2 ** 31 + 11)
    b = scans(traffic, 2 ** 31 + 11)
    c = scans(traffic, 7)
    assert torch.equal(a.points, b.points) and torch.equal(a.pose, b.pose)
    assert torch.equal(a.intensity, b.intensity)
    assert a.points.shape == c.points.shape == (16, traffic["points"], 3)
    assert not torch.equal(a.points, c.points)
    assert torch.isfinite(a.points).all()


def test_circuit_closes_and_keeps_speed():
    x, y, _ = frames.circuit(512, 1.0)
    step = np.hypot(np.diff(np.r_[x, x[0]]), np.diff(np.r_[y, y[0]]))
    assert np.allclose(step, 1.0, atol=1e-4)
    assert x[0] == 0.0 and y[0] == 0.0


def test_ring_ranges():
    s = scans(RING, 3)
    r = torch.hypot(s.points[..., 0], s.points[..., 1])
    assert float(r.min()) >= 2.0 and float(r.max()) <= 45.0


def test_hdl64_pattern():
    s = scans(HDL64, 3)
    r = torch.hypot(s.points[..., 0], s.points[..., 1])
    assert float(r.max()) <= 80.0 + 1e-3
    # the lowest laser meets the ground 1.8 / tan(24.33 deg) from the sensor
    near = float(r.min())
    assert 3.5 < near < 4.5


def test_sample_units_prefers_keyframes():
    rng = np.random.default_rng(0)
    got = loopkit.sample_units(rng, 4, 10, 100, prefer={12, 23, 34, 45})
    assert len(got) == 4 and len(set(got) & {12, 23, 34, 45}) >= 2
