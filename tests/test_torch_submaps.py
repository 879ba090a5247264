"""The port's submap store (gem_tpu_torch/global_map/submaps.py) against
gem_tpu's: staging ring, flush, compaction, capacity drops, finalize.
Pure data movement, so every field is compared exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.config import MapConfig, PipelineConfig, SubmapConfig
from gem_tpu.core.move import ShedCells as JShed
from gem_tpu.core.state import init_map_state
from gem_tpu.global_map import submaps as jsm

from gem_tpu_torch.core.move import ShedCells as TShed
from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.global_map import submaps as tsm


def _cfg(staging, **kw):
    base = dict(max_submaps=3, capacity=256, keyframe_distance=2.0,
                store_ortho=False, keyframe_scan_points=0)
    base.update(kw)
    return PipelineConfig(
        map=MapConfig(length=16, resolution=0.5, max_shift_cells=4),
        submap=SubmapConfig(staging_frames=staging, **base))


def _sheds(rng, band, n_valid, dropped=0):
    valid = np.zeros(band, bool)
    valid[rng.choice(band, size=n_valid, replace=False)] = True
    f = {k: rng.normal(size=band).astype(np.float32)
         for k in ("x", "y", "z", "variance", "intensity", "traver")}
    col = rng.integers(0, 1 << 24, band).astype(np.int32)
    j = JShed(**{k: jnp.asarray(v) for k, v in f.items()},
              color=jnp.asarray(col), valid=jnp.asarray(valid),
              dropped=jnp.int32(dropped))
    t = TShed(**{k: torch.from_numpy(v) for k, v in f.items()},
              color=torch.from_numpy(col), valid=torch.from_numpy(valid),
              dropped=torch.tensor(dropped, dtype=torch.int32))
    return j, t


def _grid(n=5):
    v = {"x": 9.0, "y": -9.0, "z": 1.0, "variance": 0.01, "intensity": 0.0,
         "traver": 0.5}
    j = jsm.PointBuffer(**{k: jnp.full((n,), x, jnp.float32)
                           for k, x in v.items()},
                        color=jnp.arange(n, dtype=jnp.int32),
                        valid=jnp.ones(n, bool))
    t = tsm.PointBuffer(**{k: torch.full((n,), x) for k, x in v.items()},
                        color=torch.arange(n, dtype=torch.int32),
                        valid=torch.ones(n, dtype=torch.bool))
    return j, t


def _assert_same(a, b, path="store"):
    if dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
        return
    x, y = np.asarray(a), b.numpy()
    assert x.dtype == y.dtype, path
    np.testing.assert_array_equal(y, x, err_msg=path)


def _drive(cfg, ops, seed=0):
    rng = np.random.default_rng(seed)
    band = 2 * cfg.map.max_shift_cells * cfg.map.length
    js, ts = jsm.init_store(cfg), tsm.init_store(cfg, "cpu")
    for op in ops:
        if op == "finalize":
            jg, tg = _grid()
            pose = np.arange(7, dtype=np.float32)
            js = jsm.finalize_submap(js, jg, jnp.asarray(pose))
            ts = tsm.finalize_submap(ts, tg, torch.from_numpy(pose))
        else:
            width, n_valid, dropped = op
            jsh, tsh = _sheds(rng, width or band, n_valid, dropped)
            js = jsm.append_shed(js, jsh)
            ts = tsm.append_shed(ts, tsh)
        _assert_same(js, ts)
    return ts


@pytest.mark.parametrize("staging", [0, 4])
def test_append_and_finalize(staging):
    ops = [(None, 20, 0), (None, 35, 2), "finalize", (None, 10, 0),
           (None, 0, 0), (None, 40, 1), "finalize"]
    ts = _drive(_cfg(staging), ops)
    assert int(ts.num_submaps) == 2


def test_ring_full_flushes_mid_stream():
    ts = _drive(_cfg(3), [(None, 12, 0)] * 7)
    assert int(ts.staging_used) == 1 and int(ts.accum_count) == 72


def test_capacity_drops_and_slot_ring_wraps():
    cfg = _cfg(2, capacity=64)
    ops = [(None, 50, 0), (None, 40, 3), "finalize"] * 2 + \
        [(None, 30, 0), "finalize", "finalize"]
    ts = _drive(cfg, ops, seed=1)
    assert int(ts.dropped) > 0 and int(ts.num_submaps) == 4
    assert ts.kf_ids.tolist() == [3, 1, 2]


def test_mismatched_band_width_compacts_immediately():
    ts = _drive(_cfg(4), [(None, 10, 0), (17, 9, 0), (None, 5, 0)])
    assert int(ts.accum_count) == 19 and int(ts.staging_used) == 1


def test_grid_to_points_matches_jax():
    cfg = _cfg(0)
    L = cfg.map.length
    rng = np.random.default_rng(3)
    elev = np.where(rng.random((L, L)) < 0.5, rng.normal(size=(L, L)),
                    -10.0).astype(np.float32)
    trav = np.where(rng.random((L, L)) < 0.8, rng.random((L, L)),
                    -10.0).astype(np.float32)
    jm = init_map_state(cfg.map).replace(
        elevation=jnp.asarray(elev), start=jnp.asarray([3, 11], jnp.int32),
        center=jnp.asarray([2.5, -1.0], jnp.float32))
    tm = MapState(**{f.name: torch.from_numpy(np.array(getattr(jm, f.name)))
                     for f in dataclasses.fields(MapState)})
    a = jsm.grid_to_points(jm, cfg, jnp.asarray(trav))
    b = tsm.grid_to_points(tm, cfg, torch.from_numpy(trav))
    _assert_same(a, b, "grid")


def test_ortho_ring_matches_jax():
    """The orthomosaic ring: (K, L, L, 3) uint8 like JAX's, and finalize
    writes the keyframe's ortho into the next slot."""
    cfg = _cfg(0, store_ortho=True)
    store = tsm.init_store(cfg, "cpu")
    jstore = jsm.init_store(cfg)
    assert store.orthos.dtype == torch.uint8
    assert tuple(store.orthos.shape) == jstore.orthos.shape == (3, 16, 16, 3)
    rng = np.random.default_rng(3)
    ortho = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    pts = tsm.empty_buffer((16 * 16,), "cpu")
    jpts = jsm.empty_buffer((16 * 16,))
    pose = np.array([1, 2, 0, 1, 0, 0, 0], np.float32)
    a = jsm.finalize_submap(jstore, jpts, jnp.asarray(pose),
                            ortho=jnp.asarray(ortho))
    b = tsm.finalize_submap(store, pts, torch.from_numpy(pose),
                            ortho=torch.from_numpy(ortho))
    np.testing.assert_array_equal(b.orthos.numpy(), np.asarray(a.orthos))
    assert b.orthos[0].sum() > 0 and int(b.orthos[1:].sum()) == 0
