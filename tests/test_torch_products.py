"""The port's render products (gem_tpu_torch/render/products.py) against
gem_tpu/render/products.py (jitted, as the JAX pipeline runs them) on the
same random map.

Tolerances: every uint8 product (costmaps, inflated costmaps, orthomosaic,
heatmap) and every selection bitwise; the distance transform and the cloud
coordinates bitwise too (the same f32 operations in the same order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.config import MapConfig
from gem_tpu.core.state import MapState as JMap
from gem_tpu.render import products as jr

from gem_tpu_torch.core.state import MapState as TMap
from gem_tpu_torch.render import products as tr


def _maps(seed, L=40, start=(7, 23)):
    rng = np.random.default_rng(seed)
    mcfg = MapConfig(length=L, resolution=0.1)
    occ = rng.random((L, L)) < 0.7
    f = {
        "elevation": np.where(occ, rng.normal(size=(L, L)), -10.0),
        "variance": np.where(occ, rng.uniform(1e-4, 0.1, (L, L)), -10.0),
        "intensity": rng.uniform(0, 50, (L, L)),
        "lowest": rng.uniform(-1, 3, (L, L)),
        "traver": np.where(occ & (rng.random((L, L)) < 0.9),
                           rng.random((L, L)), -10.0),
    }
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["color"] = rng.integers(0, 1 << 24, (L, L)).astype(np.int32)
    f["start"] = np.asarray(start, np.int32)
    f["center"] = np.asarray([1.25, -0.4], np.float32)
    f["sensor_z"] = np.float32(0.0)
    js = JMap(**{k: jnp.asarray(v) for k, v in f.items()})
    ts = TMap(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()})
    return mcfg, js, ts


def _eq(t, j, what):
    got, want = t.numpy(), np.asarray(j)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("with_start", [False, True])
def test_costmap_from_traversability(with_start):
    mcfg, js, ts = _maps(0)
    f = jax.jit(lambda t, s: jr.costmap_from_traversability(
        t, 0.4, start=s if with_start else None))
    _eq(tr.costmap_from_traversability(
        ts.traver, 0.4, start=ts.start if with_start else None),
        f(js.traver, js.start), "costmap")


def test_costmap_from_points_max_on_duplicates():
    rng = np.random.default_rng(1)
    n, size = 3000, 32
    xs = rng.uniform(-1.5, 2.0, n).astype(np.float32)
    ys = rng.uniform(-1.5, 2.0, n).astype(np.float32)
    trav = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    args = (xs, ys, trav, valid)
    want = jax.jit(lambda *a: jr.costmap_from_points(
        *a, 0.5, (-1.0, -1.2), 0.1, size))(*args)
    got = tr.costmap_from_points(*(torch.from_numpy(a) for a in args), 0.5,
                                 (-1.0, -1.2), 0.1, size)
    _eq(got, want, "costmap_from_points")
    assert {0, 254, 255} <= set(np.unique(got.numpy()).tolist())


@pytest.mark.parametrize("k,radius", [(0.0, 3.0), (5.0, 5.5), (2.0, 0.0)])
def test_distance_and_inflate(k, radius):
    mcfg, js, ts = _maps(2)
    jc = jr.costmap_from_traversability(js.traver, 0.2, start=js.start)
    tc = tr.costmap_from_traversability(ts.traver, 0.2, start=ts.start)
    _eq(tr.distance_to_lethal(tc, 4), jax.jit(
        lambda c: jr.distance_to_lethal(c, 4))(jc), "distance")
    f = jax.jit(lambda c: jr.inflate_costmap(
        c, radius, cost_scaling_factor=k, resolution=0.1,
        inscribed_radius=0.1))
    got = tr.inflate_costmap(tc, radius, cost_scaling_factor=k,
                             resolution=0.1, inscribed_radius=0.1)
    _eq(got, f(jc), "inflated")
    if radius:
        assert ((got.numpy() > 0) & (got.numpy() < 253)).any() == (k > 0)


@pytest.mark.parametrize("with_traver", [False, True])
def test_orthomosaic(with_traver):
    mcfg, js, ts = _maps(3)
    want = jax.jit(lambda s: jr.orthomosaic(
        s, mcfg, s.traver if with_traver else None))(js)
    _eq(tr.orthomosaic(ts, mcfg, ts.traver if with_traver else None), want,
        "ortho")
    assert want.shape == (40, 40, 3)


@pytest.mark.parametrize("vrange", [(None, None), (-1.0, 1.5)])
def test_elevation_heatmap(vrange):
    mcfg, js, ts = _maps(4)
    want = jax.jit(lambda s: jr.elevation_heatmap(s, mcfg, *vrange))(js)
    _eq(tr.elevation_heatmap(ts, mcfg, *vrange), want, "heatmap")
    empty = dataclasses.replace(ts, elevation=torch.full((40, 40), -10.0))
    assert int(tr.elevation_heatmap(empty, mcfg).sum()) == 0


def test_grid_point_cloud():
    mcfg, js, ts = _maps(5)
    for traver in (None, "traver"):
        a = jr.grid_point_cloud(js, mcfg, getattr(js, traver) if traver
                                else None)
        b = tr.grid_point_cloud(ts, mcfg, getattr(ts, traver) if traver
                                else None)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                          err_msg=k)
