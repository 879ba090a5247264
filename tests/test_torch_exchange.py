"""The port's submap exchange (gem_tpu_torch/multirobot/exchange.py) against
gem_tpu's: the merged store and its (robot, slot) mapping exactly, and the
joint re-stitch within the tolerances of tests/test_torch_loop_closure.py
(x, y and the payload exactly, z and variance within 1e-6 relative).

Three robots' rings of 4 slots, filled unevenly (4, 2 and 6 keyframes, so
robot 2's ring wrapped and its slots are out of trajectory order), with
points at cell centers so cell keys do not hang on a coordinate's last
bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.global_map import submaps as jsm
from gem_tpu.multirobot import exchange as jex

from gem_tpu_torch.global_map import submaps as tsm
from gem_tpu_torch.multirobot import exchange as tex
from gem_tpu_torch.utils.tree import tree_map

from test_torch_loop_closure import _FIELDS, _assert_store, _buffers

RES = 0.5


def _fleets(n_keyframes=(4, 2, 6), K=4, C=64):
    """The same fleet store in both packages (leading robot axis)."""
    import gem_tpu.config as jconfig

    from gem_tpu_torch import config as tconfig

    rng = np.random.default_rng(11)
    cfg_j = jconfig.PipelineConfig(
        map=jconfig.MapConfig(length=16, resolution=RES, max_shift_cells=4),
        submap=jconfig.SubmapConfig(
            max_submaps=K, capacity=C, keyframe_distance=2.0,
            overlap_radius=25.0, store_ortho=False, keyframe_scan_points=0))
    cfg_t = tconfig.PipelineConfig(
        map=tconfig.MapConfig(length=16, resolution=RES, max_shift_cells=4),
        submap=tconfig.SubmapConfig(
            max_submaps=K, capacity=C, keyframe_distance=2.0,
            overlap_radius=25.0, store_ortho=False, keyframe_scan_points=0))
    jstores, tstores = [], []
    for r, n in enumerate(n_keyframes):
        js, ts = jsm.init_store(cfg_j), tsm.init_store(cfg_t, "cpu")
        for k in range(n):
            f = _buffers(rng, (C,), RES, n_valid=40 + 3 * k, span=5)
            pose = np.zeros(7, np.float32)
            pose[:2] = (r + 0.5 * k, -0.5 * k)
            pose[3] = 1.0
            js = jsm.finalize_submap(js, jsm.PointBuffer(
                **{key: jnp.asarray(f[key]) for key in _FIELDS}), pose)
            ts = tsm.finalize_submap(ts, tsm.PointBuffer(
                **{key: torch.from_numpy(f[key]) for key in _FIELDS}),
                torch.from_numpy(pose))
        jstores.append(js)
        tstores.append(ts)
    jfleet = jax.tree.map(lambda *xs: jnp.stack(xs), *jstores)
    tfleet = tree_map(lambda *xs: torch.stack(xs), tstores[0], *tstores[1:])
    return cfg_j, cfg_t, jfleet, tfleet


def _assert_merged(t, j):
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(t.slots, k).numpy(),
                                      np.asarray(getattr(j.slots, k)), k)
    for k in ("counts", "centers", "poses", "num_submaps", "kf_ids",
              "accum_count", "dropped", "kf_counts"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), k)


@pytest.mark.parametrize("max_total", [None, 5, 100])
def test_merge_fleet_stores_matches_jax(max_total):
    cfg_j, cfg_t, jf, tf = _fleets()
    jm, (jr, jk) = jex.merge_fleet_stores(jf, cfg_j, max_total=max_total,
                                          return_mapping=True)
    tm, (tr, tk) = tex.merge_fleet_stores(tf, cfg_t, max_total=max_total,
                                          return_mapping=True)
    _assert_merged(tm, jm)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tk, jk)
    assert tr.dtype == tk.dtype == np.int32
    n = int(tm.num_submaps)
    assert n == min(max_total or 12, 4 + 2 + 4)
    assert tm.kf_ids[:n].tolist() == list(range(n))
    if max_total != 5:
        # robot 2's wrapped ring comes out in trajectory order
        ids = tf.kf_ids[2].numpy()
        sel = tk[tr == 2]
        assert (np.diff(ids[sel]) > 0).all()
        assert not (np.diff(sel) > 0).all()
    # without the mapping: the same store
    _assert_merged(tex.merge_fleet_stores(tf, cfg_t, max_total=max_total),
                   jm)


def test_merge_empty_fleet():
    cfg_j, cfg_t, jf, tf = _fleets(n_keyframes=(0, 0, 0))
    tm, (tr, tk) = tex.merge_fleet_stores(tf, cfg_t, return_mapping=True)
    jm = jex.merge_fleet_stores(jf, cfg_j)
    _assert_merged(tm, jm)
    assert tr.shape == tk.shape == (0,)


def test_joint_loop_closure_matches_jax():
    """Jointly optimised poses (merged order) that move every keyframe but
    the anchor by whole cells: the same re-stitch as gem_tpu's."""
    cfg_j, cfg_t, jf, tf = _fleets()
    merged = tex.merge_fleet_stores(tf, cfg_t)
    n = int(merged.num_submaps)
    rng = np.random.default_rng(3)
    opt = merged.poses.numpy()[:n].copy()
    opt[1:, :2] += RES * rng.integers(-2, 3, (n - 1, 2))
    jstore, jstats = jex.joint_loop_closure(jf, cfg_j, opt)
    tstore, tstats = tex.joint_loop_closure(tf, cfg_t, opt)
    assert tstats == jstats
    assert tstats["n_corrected"] == n and tstats["n_cells_fused"] > 50
    _assert_store(tstore, jstore)
    np.testing.assert_array_equal(tstore.poses.numpy(),
                                  np.asarray(jstore.poses))
