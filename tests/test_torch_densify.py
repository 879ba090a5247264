"""The port's submap densification (gem_tpu_torch/global_map/densify.py)
against gem_tpu's, jitted as `gem_tpu run --dense` jits it.

Order 2, on a submap-like cloud (a jittered point in most fine cells):
heights within 1e-4 m wherever both grids are valid, and equal `valid`
masks.  The moment planes are f32 sums over the same 49 shifts in the same
order, but XLA's CPU code contracts each `M + c * n` into an FMA where
PyTorch rounds the product first, and a fit on thin, one-sided support
amplifies that last bit (~1e-2 m on scattered samples), so thin support is
checked only for finite, masked output.  Order 5: the 21x21 normal
equations condition at ~1e6, so the two packages are each held to the
analytic surface with the JAX suite's own bound
(tests/test_global_map.py:165) instead of to each other.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.global_map import submaps as jsm
from gem_tpu.global_map.densify import densify_submap as jdensify

from gem_tpu_torch.global_map import submaps as tsm
from gem_tpu_torch.global_map.densify import densify_submap as tdensify

_FIELDS = ("x", "y", "z", "variance", "intensity", "traver", "color",
           "valid")


def _bufs(xs, ys, zs, C, seed=0):
    rng = np.random.default_rng(seed)
    n = len(xs)
    f = {"x": np.resize(xs, C), "y": np.resize(ys, C), "z": np.resize(zs, C),
         "variance": rng.uniform(0.005, 0.05, C),
         "intensity": np.zeros(C), "traver": rng.random(C)}
    f = {k: np.asarray(v, np.float32) for k, v in f.items()}
    f["color"] = rng.integers(0, 1 << 24, C).astype(np.int32)
    f["valid"] = np.arange(C) < n
    return (jsm.PointBuffer(**{k: jnp.asarray(f[k]) for k in _FIELDS}),
            tsm.PointBuffer(**{k: torch.from_numpy(f[k]) for k in _FIELDS}))


def _both(jb, tb, **kw):
    want = jax.jit(functools.partial(jdensify, **kw))(jb)
    got = tdensify(tb, **kw)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _terrain(seed, G, cell):
    """A submap-like cloud: one jittered point in 70% of the fine cells of
    a G x G grid, sampled from rolling terrain."""
    rng = np.random.default_rng(seed)
    g = (np.arange(G) + 0.5) * cell
    x, y = (a.reshape(-1) + rng.uniform(-0.4, 0.4, G * G) * cell
            for a in np.meshgrid(g, g, indexing="ij"))
    keep = rng.random(G * G) < 0.7
    x, y = x[keep], y[keep]
    return x, y, 0.3 * np.sin(x) + 0.1 * y * y - 0.05 * x * y


@pytest.mark.parametrize("seed,origin", [(0, (0.0, 0.0)), (1, None)])
def test_order2_matches_jax(seed, origin):
    x, y, z = _terrain(seed, 48, 0.125)
    jb, tb = _bufs(x, y, z, 2048, seed)
    want, got = _both(jb, tb, base_resolution=0.25, upsample=2,
                      grid_size=48, origin=origin, order=2)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() > 2000
    assert np.abs(got["z"] - want["z"])[v].max() <= 1e-4
    for k in ("x", "y"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    for k in ("variance", "traver"):
        np.testing.assert_allclose(got[k][v], want[k][v], rtol=1e-5)
    np.testing.assert_array_equal(got["color"], want["color"])


def test_order5_recovers_quartic_terrain():
    """One point at every fine-cell center of a surface with quartic terms:
    order 5 is exact up to f32 (< 3e-4 m in the interior, the JAX suite's
    bound) and beats order 2 by 5x, in both packages."""
    G, res = 24, 0.25
    xs, ys = np.meshgrid((np.arange(G) + 0.5) * res,
                         (np.arange(G) + 0.5) * res)
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    f = lambda x, y: (0.02 * x ** 4 + 0.015 * y ** 4 - 0.03 * x * y ** 2
                      + 0.3 * y ** 2 - 0.1 * x)
    jb, tb = _bufs(xs, ys, f(xs, ys), 1024)
    interior = np.zeros((G, G), bool)
    interior[4:-4, 4:-4] = True
    errs = {}
    for order in (2, 5):
        want, got = _both(jb, tb, base_resolution=0.5, upsample=2,
                          grid_size=G, origin=(0.0, 0.0), order=order)
        for name, out in (("jax", want), ("torch", got)):
            zz = out["z"].reshape(G, G)
            truth = f(out["x"], out["y"]).reshape(G, G)
            errs[name, order] = np.abs(zz - truth)[interior].max()
    for name in ("jax", "torch"):
        assert errs[name, 5] < 3e-4, errs
        assert errs[name, 5] < errs[name, 2] / 5, errs


def test_singular_neighbourhoods_do_not_raise():
    """Collinear support (one row of cells) makes every normal matrix
    singular but for the ridge: the solve neither raises nor yields a
    non-finite height, and the valid masks agree with the reference."""
    xs = (np.arange(20) + 0.5) * 0.25
    ys = np.full(20, 1.0)
    jb, tb = _bufs(xs, ys, 0.1 * xs, 64)
    want, got = _both(jb, tb, base_resolution=0.5, upsample=2, grid_size=16,
                      origin=(0.0, 0.0), order=2)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = got["valid"]
    assert v.any() and np.isfinite(got["z"][v]).all()


def test_order_out_of_range_raises():
    _, tb = _bufs([0.0], [0.0], [0.0], 8)
    with pytest.raises(ValueError):
        tdensify(tb, base_resolution=0.5, order=6)
