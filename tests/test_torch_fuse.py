"""The port's segment / sort / pallas fuse (gem_tpu_torch/kernels/fuse.py)
against gem_tpu's `fuse` with the same backend (pallas in Pallas interpret
mode), and the pointproc `lowest` reduction those backends need against
gem_tpu's 3-key sort.

Tolerances: color and intensity exactly (selections); elevation and
variance 5e-6 for segment and pallas (the f32 sums W and WH of a cell's
run in another order: point order, sorted order or one-hot dots), 5e-5
where one cell holds ~4000 points.  The sort backend's sums are a global
cumsum minus the carry at each run start (see test_torch_scatter.py), so
W and WH carry the rounding of the whole prefix, in JAX as in the port:
the port's sort is held to JAX's segment result within twice the distance
of JAX's own sort from it, plus 1e-6.  The port's pallas against its
segment backend: the JAX suite's own bounds (tests/test_fuse.py, rtol
3e-5 / atol 1e-5).  `lowest` bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from gem_tpu.config import BodyFilterConfig, benchmark_config
from gem_tpu.kernels import pointproc as jpp
from gem_tpu.kernels.fuse import fuse as jfuse
from gem_tpu.sensors import models as jsens

from gem_tpu_torch.kernels import pointproc as tpp
from gem_tpu_torch.kernels.fuse import FUSE_BACKENDS, fuse as tfuse

from test_torch_fuse_stream import N, T, _batches, _random_batches, _states


def _jfuse(cfg, backend, js, jb):
    jbk = "pallas_interpret" if backend == "pallas" else backend
    return jax.jit(lambda s, b: jfuse(s, cfg, b, backend=jbk))(js, jb)


def _check(cfg, backend, js, jb, b, atol=5e-6):
    """The port's fused state `b` against JAX's fuse with `backend`."""
    a = _jfuse(cfg, backend, js, jb)
    if backend == "sort":
        seg = _jfuse(cfg, "segment", js, jb)
    for k in ("elevation", "variance"):
        if backend == "sort":
            ref = np.asarray(getattr(seg, k))
            tol = 2 * np.abs(np.asarray(getattr(a, k)) - ref).max() + 1e-6
            np.testing.assert_allclose(N(getattr(b, k)), ref, rtol=0,
                                       atol=tol, err_msg=k)
        else:
            np.testing.assert_allclose(N(getattr(b, k)),
                                       np.asarray(getattr(a, k)), rtol=0,
                                       atol=atol, err_msg=k)
    np.testing.assert_array_equal(N(b.color), np.asarray(a.color))
    np.testing.assert_array_equal(N(b.intensity), np.asarray(a.intensity))


@pytest.mark.parametrize("backend", ["segment", "sort", "pallas"])
@pytest.mark.parametrize("seed,occ,valid_frac,one_cell", [
    (0, 0.5, 0.9, False), (1, 0.0, 1.0, False), (2, 1.0, 0.5, False),
    (3, 0.5, 0.95, True)])
def test_fuse_matches_jax(backend, seed, occ, valid_frac, one_cell):
    rng = np.random.default_rng(seed)
    L, P = (32, 4096) if one_cell else (40, 2048)
    cfg = benchmark_config(length=L, max_points=P)
    js, ts = _states(rng, cfg.map, occ)
    jb, tb = _random_batches(rng, L, P, valid_frac,
                             one_cell=L * L // 2 if one_cell else None)
    b = tfuse(ts, cfg, tb, backend=backend)
    _check(cfg, backend, js, jb, b, atol=5e-5 if one_cell else 5e-6)
    if backend == "pallas":
        c = tfuse(ts, cfg, tb, backend="segment")
        for k in ("elevation", "variance", "intensity"):
            np.testing.assert_allclose(N(getattr(b, k)), N(getattr(c, k)),
                                       rtol=3e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(N(b.color), N(c.color))


def test_colored_outliers_take_the_overwrite_payload():
    """Half the lanes colored, 10% lifted 1 m over a tight prior: the
    overwrite path's color payload and the min-v inlier payload."""
    rng = np.random.default_rng(8)
    L, P = 32, 2048
    cfg = benchmark_config(length=L, max_points=P)
    js, ts = _states(rng, cfg.map, 0.8)
    elev = N(ts.elevation).reshape(-1)
    cell = rng.integers(0, L * L, P).astype(np.int32)
    base = np.where(elev[cell] == -10.0, 0.0, elev[cell])
    h = (base + rng.normal(0, 0.01, P)
         + (rng.random(P) < 0.1) * 1.0).astype(np.float32)
    v = (rng.integers(1, 6, P) * 1e-3).astype(np.float32)
    col = np.where(rng.random(P) < 0.5, rng.integers(1, 1 << 24, P),
                   0).astype(np.int32)
    inten = np.where(col != 0, rng.uniform(1, 50, P), 0.0).astype(np.float32)
    jb, tb = _batches(L, h, v, cell, np.ones(P, bool), col, inten)
    for backend in ("segment", "sort", "pallas"):
        b = tfuse(ts, cfg, tb, backend=backend)
        _check(cfg, backend, js, jb, b)
        assert int((N(b.color) != N(ts.color)).sum()) > 100


@pytest.mark.parametrize("start", [(0, 0), (13, 6)])
def test_lowest_reduction_matches_jax(start):
    """The pointproc `lowest` reduction over JAX's own processed points:
    per geographic cell the min-h point, max v among exact-h ties (heights
    quantized to 0.25 m, with -0.0 among them), bound h + 3v; bitwise the
    plane of JAX's 3-key sort, h - 3 * (-v)."""
    rng = np.random.default_rng(sum(start))
    L, P = 24, 3000
    cfg = benchmark_config(length=L, max_points=P).replace(
        body_filter=BodyFilterConfig(mode="none"))
    js, ts = _states(rng, cfg.map, 0.3, start=start)
    pts = np.stack([rng.uniform(-1.3, 1.3, P), rng.uniform(-1.3, 1.3, P),
                    rng.integers(-6, 7, P) * 0.25], -1).astype(np.float32)
    pts[rng.random(P) < 0.05, 2] = -0.0
    valid = rng.random(P) < 0.9
    R = np.eye(3, dtype=np.float32)
    ji = jsens.jacobian_ingredients(R, R, np.zeros(3, np.float32))
    cov = np.diag([0.0, 0.0, 0.0]).astype(np.float32)
    jbatch, jlow = jax.jit(lambda s, p: jpp.process_points(
        s, cfg, p, np.ones(P, np.float32), valid, np.eye(4, dtype=np.float32),
        np.float32(0.0), ji[0], cov, *ji[1:]))(js, pts)
    cell, ok = np.asarray(jbatch.cell), np.asarray(jbatch.valid)
    geo = ((cell // L - start[0]) % L) * L + (cell % L - start[1]) % L
    low = tpp.lowest_bound(ts.lowest, T(geo), T(jbatch.height),
                           T(jbatch.variance), T(ok), L)
    np.testing.assert_array_equal(N(low), np.asarray(jlow))
    assert (N(low) != N(ts.lowest)).sum() > 50
    # through process_points and fuse: the port's own points, the same
    # reduction, whichever backend fuses
    tbatch = tpp.process_points(
        ts, cfg, T(pts), torch.ones(P), T(valid), torch.eye(4),
        torch.tensor(0.0), T(ji[0]), T(cov), *[T(a) for a in ji[1:]])
    tcell = N(tbatch.cell)
    tgeo = ((tcell // L - start[0]) % L) * L + (tcell % L - start[1]) % L
    want = N(tpp.lowest_bound(ts.lowest, T(tgeo), tbatch.height,
                              tbatch.variance, tbatch.valid, L))
    for backend in FUSE_BACKENDS:
        np.testing.assert_array_equal(
            N(tfuse(ts, cfg, tbatch, backend=backend).lowest), want,
            err_msg=backend)
