"""The port's raytrace cleanup (plain tensor code, no kernel) against
gem_tpu's, including the pooled far field (p > 1).

The port reuses the reference's static NumPy tables, turns each constant-
key sort into a gather and each reversed cummin into flip/cummin/flip: pure
data movement and min, so deletions and the reset lowest plane are
compared exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.config import MapConfig
from gem_tpu.core.state import init_map_state
from gem_tpu.kernels import raytrace as jrt

from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels import raytrace as trt


def _scene(L, seed, start):
    rng = np.random.default_rng(seed)
    elev = rng.normal(0.0, 0.2, (L, L)).astype(np.float32)
    lowest = rng.normal(-0.2, 0.3, (L, L)).astype(np.float32)
    lowest[rng.random((L, L)) < 0.3] = 10.0
    lowest[rng.random((L, L)) < 0.1] = 100.0
    obs = rng.random((L, L)) < 0.08
    elev[obs] += rng.uniform(1.5, 3.0, obs.sum())
    elev[rng.random((L, L)) < 0.1] = -10.0
    traver = np.where(obs, 0.1, 1.0).astype(np.float32)
    var = rng.uniform(1e-4, 0.02, (L, L)).astype(np.float32)
    return elev, lowest, traver, var


@pytest.mark.parametrize("L,pool,rays,start", [
    (33, 0, 0, (0, 0)),           # odd length, exact far field
    (64, 0, 0, (11, 5)),
    (128, 2, 128, (17, 90)),      # pooled far field, p = 2
    (96, 3, 0, (40, 7)),          # p = 3 (the flagship's auto value)
])
def test_matches_jax(L, pool, rays, start):
    cfg = MapConfig(length=L, resolution=0.2, raytrace_far_pool=pool,
                    raytrace_num_rays=rays)
    elev, lowest, traver, var = _scene(L, L + pool, start)
    js = init_map_state(cfg).replace(
        elevation=jnp.asarray(elev), variance=jnp.asarray(var),
        lowest=jnp.asarray(lowest), sensor_z=jnp.float32(1.2),
        start=jnp.asarray(start, jnp.int32))
    ts = MapState(**{f.name: torch.from_numpy(np.array(getattr(js, f.name)))
                     for f in dataclasses.fields(MapState)})
    a = jrt.raytrace_cleanup(js, cfg, jnp.asarray(traver))
    b = trt.raytrace_cleanup(ts, cfg, torch.from_numpy(traver))
    deleted = (np.asarray(a.elevation) == -10.0) & (elev != -10.0)
    assert deleted.sum() > 5, "scene must exercise deletion"
    np.testing.assert_array_equal(b.elevation.numpy(),
                                  np.asarray(a.elevation))
    np.testing.assert_array_equal(b.lowest.numpy(), np.asarray(a.lowest))
    assert trt._far_pool(cfg) == jrt._far_pool(cfg)


@pytest.mark.parametrize("L,R,G", [(40, 128, 2), (100, 384, 2)])
def test_tables_are_the_references(L, R, G):
    for a, b in zip(trt._tables(L, R, G), jrt._tables(L, R, G)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for cap in (192.0, 96.0):
        for a, b in zip(trt._near_tables(L, R, cap),
                        jrt._near_tables(L, R, cap)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_permutations_invert_the_constant_key_sorts():
    L, R, G = 24, 128, 2
    d, key1, key2, cap, nslots = trt._tables(L, R, G)
    _, _, to_slots, to_cells, _, _ = trt._device_tables(L, R, G, "cpu")
    vals = np.random.default_rng(0).normal(size=nslots).astype(np.float32)
    np.testing.assert_array_equal(vals[to_slots.numpy()],
                                  vals[np.argsort(key1)])
    slots = np.sort(key2)                     # lax.sort by key2, first L*L
    np.testing.assert_array_equal(key2[to_cells.numpy()], slots[:L * L])


def test_suffix_min_beyond():
    x = torch.tensor([[3.0, 1.0, 4.0, 1.5, 9.0], [5.0, 2.0, 6.0, 0.5, 3.0]])
    want = torch.tensor([[1.0, 1.5, 1.5, 9.0, float("inf")],
                         [0.5, 0.5, 0.5, 3.0, float("inf")]])
    assert torch.equal(trt._suffix_min_beyond(x), want)
