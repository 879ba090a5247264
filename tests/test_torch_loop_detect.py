"""The port's inter-robot loop detection (gem_tpu_torch/multirobot/
loop_detect.py) against gem_tpu's, on the scenarios of
tests/test_loop_detect.py.

The BEV rasterisation, the FFTs and the signatures are float32 in both
packages, but XLA's and PyTorch's FFTs, cos and sin differ in their last
bits, so the port is held by outcome: the same loops (`n_loops`, `pairs`;
loops come strongest first, and the scenarios' identical scenes tie their
cosine similarities at 1.0 within rounding, so pairs are compared as sets
and loops matched by pair), each factor's yaw within 1e-4 rad and
translation within 1e-3 m, corrected poses within 1e-3 m, and the true-position checks of the JAX suite.  The
pose-graph solvers are NumPy in both packages: equal to 1e-9.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.global_map import submaps as jsm
from gem_tpu.multirobot import loop_detect as jld

from gem_tpu_torch.global_map import submaps as tsm
from gem_tpu_torch.mapping.pipeline import _from_tree
from gem_tpu_torch.multirobot import loop_detect as tld

from test_loop_detect import _cfg, _robot_store

THETA = 2 * math.pi * 5 / 64        # an exact sector multiple


def _tcfg():
    from gem_tpu_torch import config as C

    j = _cfg()
    return C.PipelineConfig(
        map=C.MapConfig(length=j.map.length, resolution=j.map.resolution),
        sensor=C.SensorConfig(model="laser"),
        body_filter=C.BodyFilterConfig(mode="none"),
        submap=C.SubmapConfig(**{k: getattr(j.submap, k) for k in (
            "max_submaps", "capacity", "keyframe_distance", "store_ortho",
            "keyframe_scan_points", "overlap_radius")}),
        max_points=j.max_points)


def _fleet(a_places, b_places, drift=(0.0, (0.0, 0.0)), drift_z=0.0):
    """Robot A (unbiased) and robot B (drifted) as a JAX fleet store, and
    the same store in the port."""
    cfg = _cfg()
    fleet = jax.tree.map(lambda *xs: jnp.stack(xs),
                         _robot_store(cfg, a_places),
                         _robot_store(cfg, b_places, drift=drift,
                                      drift_z=drift_z))
    return fleet, _from_tree(tsm.SubmapStore,
                             jax.tree.map(np.asarray, fleet), "cpu")


_PLACES = [(7, (0.0, 0.0)), (8, (14.0, 3.0))]
_SCENARIOS = {
    # name: (A's places, B's places, drift, z drift, center_gate, loops)
    "end_to_end": (_PLACES, _PLACES, (THETA, (1.2, -0.8)), 0.0, None, True),
    "z_drift": (_PLACES, _PLACES, (THETA, (1.2, -0.8)), 0.7, None, True),
    "large_drift_default_gate": (
        [(7, (0.0, 0.0)), (8, (9.0, 14.0))],
        [(7, (0.0, 0.0)), (8, (9.0, 14.0))], (0.0, (12.0, 0.0)), 0.0,
        None, False),
    "large_drift_wide_gate": (
        [(7, (0.0, 0.0)), (8, (9.0, 14.0))],
        [(7, (0.0, 0.0)), (8, (9.0, 14.0))], (0.0, (12.0, 0.0)), 0.0,
        18.0, True),
    "distinct_areas": ([(7, (0.0, 0.0))], [(99, (200.0, 200.0))],
                       (0.0, (0.0, 0.0)), 0.0, None, False),
}


def _yaw_of_factor(q):
    return 2 * math.atan2(float(q[6]), float(q[3]))


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_fleet_loop_closure_matches_jax(name):
    a, b, drift, dz, gate, has_loops = _SCENARIOS[name]
    jfleet, tfleet = _fleet(a, b, drift, dz)
    jc, js, jr = jld.fleet_loop_closure(jfleet, _cfg(), center_gate=gate)
    tc, ts, tr = tld.fleet_loop_closure(tfleet, _tcfg(), center_gate=gate)
    assert ts["n_loops"] == js["n_loops"]
    assert (ts["n_loops"] >= 2) == has_loops, ts
    if not has_loops:
        assert ts == js and tr.items == [] and jr.items == []
        return
    assert sorted(ts["pairs"]) == sorted(js["pairs"])
    for k in ("n_z_loops", "n_corrected", "n_pairs", "n_rounds"):
        assert ts[k] == js[k], k
    # the records field for field: ids and flags exactly, the anchor pose
    # exactly, the factor (t, dz, quaternion of -yaw) within the bounds
    assert len(tr.items) == len(jr.items) == ts["n_loops"]
    by_pair = lambda items: sorted(items, key=lambda x: (x.id0, x.id1))
    for t, j in zip(by_pair(tr.items), by_pair(jr.items)):
        assert (t.id0, t.id1, t.is_aerial, t.is_checked) \
            == (j.id0, j.id1, j.is_aerial, j.is_checked)
        np.testing.assert_array_equal(t.id0_pose, j.id0_pose)
        np.testing.assert_allclose(t.factor_pose[:2], j.factor_pose[:2],
                                   atol=1e-3)
        np.testing.assert_allclose(t.factor_pose[2], j.factor_pose[2],
                                   atol=1e-3)
        assert abs(_yaw_of_factor(t.factor_pose)
                   - _yaw_of_factor(j.factor_pose)) < 1e-4
        assert t.factor_pose.dtype == j.factor_pose.dtype == np.float32
    n = int(tc.num_submaps)
    np.testing.assert_allclose(tc.poses.numpy()[:n, :3],
                               np.asarray(jc.poses)[:n, :3], atol=1e-3)
    np.testing.assert_allclose(tc.slots.z.numpy(), np.asarray(jc.slots.z),
                               atol=1e-3)
    # the JAX suite's own checks on the port: B back at the true places
    poses = tc.poses.numpy()
    bev_res = 2 * _cfg().submap.overlap_radius / 128
    for idx, (_, place) in enumerate(b):
        np.testing.assert_allclose(poses[2 + idx, :2], place,
                                   atol=3 * bev_res)
    assert ts["max_pose_correction_m"] > 0.5
    assert ts["n_cells_fused"] > 0
    if dz:
        assert ts["n_z_loops"] >= 1 and ts["max_z_correction_m"] > 0.5
        for v in ts["loop_dz_m"]:
            assert abs(v + dz) < 0.05
        np.testing.assert_allclose(poses[2:4, 2], 0.0, atol=0.05)
        zb = tc.slots.z[2].numpy()[tc.slots.valid[2].numpy()]
        assert abs(np.median(zb) - 1.0) < 0.05
        assert all(abs(x.factor_pose[2] + dz) < 0.05 for x in tr.items)
    if name == "end_to_end":
        xa = tc.slots.x[0].numpy()[tc.slots.valid[0].numpy()]
        ya = tc.slots.y[0].numpy()[tc.slots.valid[0].numpy()]
        xb = tc.slots.x[2].numpy()[tc.slots.valid[2].numpy()]
        yb = tc.slots.y[2].numpy()[tc.slots.valid[2].numpy()]
        d = np.hypot(xa[None, :] - xb[:, None],
                     ya[None, :] - yb[:, None]).min(axis=1)
        assert np.median(d) < 3 * bev_res


def test_detect_inter_loops_factors_match_jax():
    """The factors themselves: yaw within 1e-4 rad, t within 1e-3 m, the
    similarity within 1e-4, the z offset within 1e-3 m and its support
    within 1% of cells."""
    jfleet, tfleet = _fleet(_PLACES, _PLACES, (THETA, (1.2, -0.8)), 0.7)
    from gem_tpu.multirobot.exchange import merge_fleet_stores as jmerge

    from gem_tpu_torch.multirobot.exchange import merge_fleet_stores

    jm, (jr, _) = jmerge(jfleet, _cfg(), return_mapping=True)
    tm, (tr, _) = merge_fleet_stores(tfleet, _tcfg(), return_mapping=True)
    jl = jld.detect_inter_loops(jm, np.asarray(jr), _cfg())
    tl = tld.detect_inter_loops(tm, tr, _tcfg())
    by_pair = lambda loops: sorted(loops, key=lambda x: (x.i, x.j))
    tl, jl = by_pair(tl), by_pair(jl)
    assert [(x.i, x.j) for x in tl] == [(x.i, x.j) for x in jl]
    assert len(tl) >= 2
    for t, j in zip(tl, jl):
        assert abs(t.yaw - j.yaw) < 1e-4
        np.testing.assert_allclose(t.t, j.t, atol=1e-3)
        assert abs(t.similarity - j.similarity) < 1e-4
        assert abs(t.peak - j.peak) < 1e-3
        assert abs(t.dz - j.dz) < 1e-3
        assert abs(t.z_cells - j.z_cells) <= 0.01 * j.z_cells


def test_phase_correlation_convention():
    """img_a(p) = img_b(p - d): the JAX suite's pinned case gives (-5, 3),
    batched or not."""
    rng = np.random.default_rng(0)
    G = 64
    img_a = (rng.random((G, G)) < 0.1).astype(np.float32)
    img_b = np.roll(img_a, (5, -3), axis=(0, 1))
    dx, dy, peak = tld.phase_correlate_2d(torch.from_numpy(img_a),
                                          torch.from_numpy(img_b))
    assert (float(dx), float(dy)) == (-5.0, 3.0) and float(peak) > 0.5
    jdx, jdy, jpeak = jax.jit(jld.phase_correlate_2d)(jnp.asarray(img_a),
                                                      jnp.asarray(img_b))
    assert abs(float(peak) - float(jpeak)) < 1e-5
    stack = torch.stack([torch.from_numpy(img_b),
                         torch.from_numpy(np.roll(img_a, (-2, 7), (0, 1)))])
    bdx, bdy, bpeak = tld.phase_correlate_2d(torch.from_numpy(img_a), stack)
    assert bdx.tolist() == [-5.0, 2.0] and bdy.tolist() == [3.0, -7.0]
    assert float(bpeak[0]) == float(peak)


@pytest.mark.parametrize("yaw", [0.0, 0.3, -1.1])
def test_bev_images_match_jax(yaw):
    """Absolute and normalised BEVs of one submap: the same occupied cells
    and heights (float32 sin/cos may move a point on a cell edge, so 99.9%
    of cells), and one batched call equals the single ones."""
    rng = np.random.default_rng(2)
    C = 4000
    x = rng.uniform(-30, 30, C).astype(np.float32)
    y = rng.uniform(-30, 30, C).astype(np.float32)
    z = rng.normal(1.0, 0.5, C).astype(np.float32)
    valid = rng.random(C) < 0.9
    f = dict(x=x, y=y, z=z, variance=np.full(C, 0.1, np.float32),
             intensity=np.zeros(C, np.float32),
             traver=np.zeros(C, np.float32), color=np.zeros(C, np.int32),
             valid=valid)
    jb = jsm.PointBuffer(**{k: jnp.asarray(v) for k, v in f.items()})
    tb = tsm.PointBuffer(**{k: torch.from_numpy(v) for k, v in f.items()})
    c = np.asarray([1.3, -2.1], np.float32)
    for jfn, tfn in ((jld._bev_raw, tld._bev_raw),
                     (jld.cartesian_bev, tld.cartesian_bev)):
        jimg = np.asarray(jax.jit(lambda b, cc, w: jfn(b, cc, 25.0, 128,
                                                       yaw=w))(
            jb, jnp.asarray(c), jnp.float32(yaw)))
        timg = tfn(tb, torch.from_numpy(c), 25.0, 128, yaw=yaw).numpy()
        assert timg.shape == (128, 128)
        same = (timg == jimg) | (np.isinf(timg) & np.isinf(jimg))
        assert same.mean() >= 0.999, same.mean()
        batch = tfn(tb, torch.from_numpy(c), 25.0, 128,
                    yaw=torch.tensor([yaw, 0.0]))
        assert torch.equal(batch[0], torch.from_numpy(timg))
    if yaw == 0.0:          # no rotation: the cell indices are bitwise
        assert (timg == jimg).all()


def test_pose_graph_solvers_match_jax():
    """SE(2) Gauss-Newton and the linear z graph on a random 3-robot graph
    with loop edges: equal to 1e-9 (NumPy in both packages)."""
    rng = np.random.default_rng(4)
    N = 12
    xyt = np.concatenate([rng.normal(0, 5, (N, 2)),
                          rng.uniform(-3, 3, (N, 1))], axis=1)
    edges = [(k, k + 1, rng.normal(0, 1, 3), 1.0) for k in range(N - 1)
             if k % 4 != 3]
    edges += [(0, 5, rng.normal(0, 1, 3), 10.0), (2, 9, rng.normal(0, 1, 3),
                                                  10.0)]
    np.testing.assert_allclose(tld.optimize_pose_graph(xyt, edges),
                               jld.optimize_pose_graph(xyt, edges),
                               rtol=0, atol=1e-9)
    z0 = rng.normal(0, 1, N)
    zedges = [(i, j, float(rng.normal()), w) for i, j, _, w in edges]
    np.testing.assert_allclose(tld.optimize_z_graph(z0, zedges),
                               jld.optimize_z_graph(z0, zedges),
                               rtol=0, atol=1e-9)
    out = tld.optimize_pose_graph(np.asarray([[0, 0, 0], [2.0, 1.0, 0.5]]),
                                  [(0, 1, np.asarray([1.0, 0.0, 0.0]), 10.0)])
    np.testing.assert_allclose(out[1], [1.0, 0.0, 0.0], atol=1e-4)


def test_drift_consensus_matches_jax():
    """Per robot pair, with an outlier: the same loops kept."""
    def loops(mod):
        mk = lambda i, j, t: mod.InterLoop(i=i, j=j, yaw=0.0,
                                           t=np.asarray(t, np.float64),
                                           similarity=0.95, peak=0.5)
        return [mk(0, 2, (1.0, 0.0)), mk(1, 2, (1.0, 0.05)),
                mk(0, 3, (-2.0, 1.0)), mk(0, 2, (40.0, -7.0))]

    xyt = np.zeros((4, 3))
    robot_of = np.asarray([0, 0, 1, 2])
    kt = tld._drift_consensus(loops(tld), xyt, robot_of)
    kj = jld._drift_consensus(loops(jld), xyt, robot_of)
    assert [(x.i, x.j, tuple(x.t)) for x in kt] \
        == [(x.i, x.j, tuple(x.t)) for x in kj]
    assert len(kt) == 3
