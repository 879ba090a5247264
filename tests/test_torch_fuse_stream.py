"""The port's streaming fuse (gem_tpu_torch/kernels/fuse_stream.py, the
module of kernel K1) against gem_tpu's `fuse_stream` run in Pallas
interpret mode, over the cases of tests/test_fuse_stream.py, plus the
16-row aggregate contract against a per-cell NumPy loop.

Tolerances: elevation/variance/intensity 5e-6 (f32 sums of a cell's run
taken in another order than the interpret-mode one-hot dots; the JAX suite's
stream-vs-segment bound), 5e-5 where one cell sums 4096 terms; color
exact; lowest 1e-6 (a selected h + 3v, no sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.config import benchmark_config
from gem_tpu.core.state import init_map_state
from gem_tpu.kernels.fuse_stream import fuse_stream as jfuse_stream
from gem_tpu.kernels.pointproc import PointBatch as JBatch

from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels import fuse_stream as tfs
from gem_tpu_torch.kernels.pointproc import PointBatch as TBatch


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _states(rng, mcfg, occupancy=0.5, start=(7, 29)):
    L = mcfg.length
    elev = np.full((L, L), mcfg.invalid_elevation, np.float32)
    var = np.full((L, L), mcfg.invalid_variance, np.float32)
    occ = rng.random((L, L)) < occupancy
    elev[occ] = rng.normal(size=occ.sum()).astype(np.float32)
    var[occ] = rng.uniform(1e-4, 0.2, occ.sum()).astype(np.float32)
    js = init_map_state(mcfg).replace(
        elevation=jnp.asarray(elev), variance=jnp.asarray(var),
        start=jnp.asarray(start, jnp.int32),
        lowest=jnp.asarray(rng.uniform(-1, 3, (L, L)).astype(np.float32)),
        color=jnp.asarray(rng.integers(0, 1 << 24, (L, L)), jnp.int32),
        intensity=jnp.asarray(rng.random((L, L)).astype(np.float32)))
    ts = MapState(**{f.name: T(getattr(js, f.name))
                     for f in dataclasses.fields(MapState)})
    return js, ts


def _batches(L, h, v, cell, valid, col, inten):
    cell = np.where(valid, cell, L * L).astype(np.int32)
    P = h.shape[0]
    jb = JBatch(xy=jnp.zeros((P, 2)), height=jnp.asarray(h),
                variance=jnp.asarray(v), cell=jnp.asarray(cell),
                color=jnp.asarray(col), intensity=jnp.asarray(inten),
                valid=jnp.asarray(valid))
    tb = TBatch(xy=torch.zeros((P, 2)), height=T(h), variance=T(v),
                cell=T(cell), color=T(col), intensity=T(inten),
                valid=T(valid))
    return jb, tb


def _random_batches(rng, L, P, valid_frac=0.9, one_cell=None):
    cell = (np.full(P, one_cell) if one_cell is not None
            else rng.integers(0, L * L, P)).astype(np.int32)
    valid = rng.random(P) < valid_frac
    h = (rng.normal(size=P) * 2).astype(np.float32)
    v = rng.uniform(1e-4, 0.3, P).astype(np.float32)
    col = np.where(rng.random(P) < 0.6, rng.integers(1, 1 << 24, P),
                   0).astype(np.int32)
    inten = np.where(col != 0, rng.uniform(0.1, 1.0, P), 0.0).astype(
        np.float32)
    return _batches(L, h, v, cell, valid, col, inten)


def _run_both(cfg, js, ts, jb, tb, with_lowest=True, with_color=True):
    a = jax.jit(lambda s, b: jfuse_stream(
        s, cfg, b, with_lowest=with_lowest, with_color=with_color,
        interpret=True))(js, jb)
    b = tfs.fuse_stream(ts, cfg, tb, with_lowest=with_lowest,
                        with_color=with_color)
    return a, b


def _compare(a, b, atol=5e-6, lowest=True):
    for k in ("elevation", "variance", "intensity"):
        np.testing.assert_allclose(N(getattr(b, k)), N(getattr(a, k)),
                                   rtol=0, atol=atol, err_msg=k)
    np.testing.assert_array_equal(N(b.color), N(a.color))
    if lowest:
        np.testing.assert_allclose(N(b.lowest), N(a.lowest), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("seed,occ,valid_frac", [(0, 0.5, 0.9),
                                                 (1, 0.0, 1.0),
                                                 (2, 1.0, 0.5)])
def test_random_batch(seed, occ, valid_frac):
    rng = np.random.default_rng(seed)
    cfg = benchmark_config(length=40, max_points=2048)
    js, ts = _states(rng, cfg.map, occ)
    jb, tb = _random_batches(rng, 40, 2048, valid_frac)
    _compare(*_run_both(cfg, js, ts, jb, tb))


def test_all_points_one_cell():
    rng = np.random.default_rng(3)
    L = 32
    cfg = benchmark_config(length=L, max_points=4096)
    js, ts = _states(rng, cfg.map, 0.5)
    jb, tb = _random_batches(rng, L, 4096, 0.95, one_cell=L * L // 2)
    _compare(*_run_both(cfg, js, ts, jb, tb), atol=5e-5)


def test_empty_batch_floors_variance():
    rng = np.random.default_rng(4)
    cfg = benchmark_config(length=24, max_points=256)
    js, ts = _states(rng, cfg.map, 0.5)
    jb, tb = _random_batches(rng, 24, 256, valid_frac=0.0)
    a, b = _run_both(cfg, js, ts, jb, tb)
    _compare(a, b)
    assert N(b.variance).min() >= cfg.map.min_variance


def test_lowest_is_the_geographic_min_bound():
    """The ride-along lowest: per geographic cell, the min-h point's h + 3v
    (last in batch order at an exact h tie), min'd into the old plane."""
    rng = np.random.default_rng(5)
    L, start = 40, (13, 6)
    cfg = benchmark_config(length=L, max_points=2048)
    js, ts = _states(rng, cfg.map, 0.3, start=start)
    jb, tb = _random_batches(rng, L, 2048)
    a, b = _run_both(cfg, js, ts, jb, tb)
    _compare(a, b)
    cell, valid = N(tb.cell), N(tb.valid)
    geo = ((cell // L - start[0]) % L) * L + (cell % L - start[1]) % L
    h, var = N(tb.height), N(tb.variance)
    want = N(ts.lowest).reshape(-1).copy()
    for c in np.unique(geo[valid]):
        m = valid & (geo == c)
        i = np.nonzero(m & (h == h[m].min()))[0][-1]
        want[c] = min(want[c], h[i] + np.float32(3.0) * var[i])
    np.testing.assert_array_equal(N(b.lowest).reshape(-1), want)


def test_nan_invalid_points_stay_inert():
    rng = np.random.default_rng(11)
    L = 40
    cfg = benchmark_config(length=L, max_points=512)
    js, ts = _states(rng, cfg.map, 0.5)
    _, tb = _random_batches(rng, L, 512, 0.9)
    h, v = N(tb.height).copy(), N(tb.variance).copy()
    it, valid = N(tb.intensity).copy(), N(tb.valid).copy()
    h[7], v[9], it[11] = np.nan, np.nan, np.nan
    valid[[7, 9, 11]] = False
    jbad, tbad = _batches(L, h, v, N(tb.cell), valid, N(tb.color), it)
    _, tref = _batches(L, N(tb.height), N(tb.variance), N(tb.cell), valid,
                       N(tb.color), N(tb.intensity))
    a, b = _run_both(cfg, js, ts, jbad, tbad)
    c = tfs.fuse_stream(ts, cfg, tref)
    for k in ("elevation", "variance", "lowest", "intensity", "color"):
        assert not np.isnan(N(getattr(b, k))).any(), k
        np.testing.assert_array_equal(N(getattr(b, k)), N(getattr(c, k)),
                                      err_msg=k)
    _compare(a, b)


def test_tie_rule_is_batch_order():
    """At an exact height tie the first point in batch order wins (the
    reference G_fuse rule, gem_tpu's default 2-key sort)."""
    L = 16
    cfg = benchmark_config(length=L, max_points=8)
    mcfg = cfg.map
    elev = np.full((L, L), mcfg.invalid_elevation, np.float32)
    var = np.full((L, L), mcfg.invalid_variance, np.float32)
    elev[5, 3], var[5, 3] = 0.0, 1e-4     # tight prior: h=2 is an outlier
    js = init_map_state(mcfg).replace(elevation=jnp.asarray(elev),
                                      variance=jnp.asarray(var))
    ts = MapState(**{f.name: T(getattr(js, f.name))
                     for f in dataclasses.fields(MapState)})
    h = np.zeros(8, np.float32)
    v = np.full(8, 0.5, np.float32)
    h[0], v[0] = 2.0, 0.3
    h[1], v[1] = 2.0, 0.1
    valid = np.arange(8) < 2
    jb, tb = _batches(L, h, v, np.full(8, 5 * L + 3), valid,
                      np.zeros(8, np.int32), np.zeros(8, np.float32))
    a, b = _run_both(cfg, js, ts, jb, tb)
    assert N(b.elevation)[5, 3] == 2.0
    assert N(b.variance)[5, 3] == np.float32(0.3)
    _compare(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tie_fuzz(seed):
    """Quantized heights and variances: exact h and v ties everywhere.  The
    port's packed-key sort must reproduce the 2-key order, so color and
    intensity agree exactly, including the min-v tie payload rule."""
    rng = np.random.default_rng(100 + seed)
    L, P = 24, 4096
    cfg = benchmark_config(length=L, max_points=P)
    js, ts = _states(rng, cfg.map, 0.5)
    cell = rng.integers(0, L * L // 8, P).astype(np.int32)
    h = (rng.integers(-8, 9, P) * 0.25).astype(np.float32)
    h[rng.random(P) < 0.05] = -0.0          # -0.0 and 0.0 tie, as in lax
    v = (rng.integers(1, 5, P) * 0.05).astype(np.float32)
    col = np.where(rng.random(P) < 0.5, rng.integers(1, 1 << 24, P),
                   0).astype(np.int32)
    inten = np.where(col != 0, rng.integers(1, 4, P) * 0.25,
                     0.0).astype(np.float32)
    valid = rng.random(P) < 0.95
    jb, tb = _batches(L, h, v, cell, valid, col, inten)
    a, b = _run_both(cfg, js, ts, jb, tb)
    _compare(a, b, atol=1e-5)
    np.testing.assert_array_equal(N(b.intensity), N(a.intensity))


def test_colorless_mode():
    rng = np.random.default_rng(6)
    L = 32
    cfg = benchmark_config(length=L, max_points=1024)
    js, ts = _states(rng, cfg.map, 0.5)
    _, tb = _random_batches(rng, L, 1024)
    zc, zi = np.zeros(1024, np.int32), np.zeros(1024, np.float32)
    jb, tb = _batches(L, N(tb.height), N(tb.variance), N(tb.cell),
                      N(tb.valid), zc, zi)
    a, b = _run_both(cfg, js, ts, jb, tb, with_color=False)
    _compare(a, b)
    np.testing.assert_array_equal(N(b.color), N(ts.color))
    np.testing.assert_array_equal(N(b.intensity), N(ts.intensity))
    c = tfs.fuse_stream(ts, cfg, tb, with_color=True)
    for k in ("elevation", "variance", "lowest"):
        np.testing.assert_array_equal(N(getattr(b, k)), N(getattr(c, k)))


def test_colored_outliers_and_inliers():
    """Half the lanes colored, some lifted 1 m above a tight prior: colored
    outlier start rows take the overwrite path's payload (rows 7-10) and
    colored inliers the min-v payload (rows 12-14)."""
    rng = np.random.default_rng(8)
    L, P = 32, 2048
    cfg = benchmark_config(length=L, max_points=P)
    js, ts = _states(rng, cfg.map, 0.8)
    elev = N(ts.elevation)
    cell = rng.integers(0, L * L, P).astype(np.int32)
    base = np.where(elev.reshape(-1)[cell] == -10.0, 0.0,
                    elev.reshape(-1)[cell])
    h = (base + rng.normal(0, 0.01, P)
         + (rng.random(P) < 0.1) * 1.0).astype(np.float32)
    v = (rng.integers(1, 6, P) * 1e-3).astype(np.float32)
    col = np.where(rng.random(P) < 0.5, rng.integers(1, 1 << 24, P),
                   0).astype(np.int32)
    inten = np.where(col != 0, rng.uniform(1, 50, P), 0.0).astype(np.float32)
    jb, tb = _batches(L, h, v, cell, np.ones(P, bool), col, inten)
    a, b = _run_both(cfg, js, ts, jb, tb)
    _compare(a, b)
    np.testing.assert_array_equal(N(b.intensity), N(a.intensity))
    rows = tfs.fuse_stream_aggregate(
        *tfs.sort_points(tb, L * L), ts.elevation.reshape(-1),
        ts.variance.reshape(-1), cfg.map)
    assert int((rows[7] > 0).sum()) > 10          # colored outlier starts
    assert int(torch.isfinite(rows[12]).sum()) > 100


# --- the sort and the 16-row contract ----------------------------------------


def test_sort_key_orders_cell_then_descending_height():
    rng = np.random.default_rng(12)
    L, P = 8, 600
    h = (rng.integers(-4, 5, P) * 0.5).astype(np.float32)
    h[rng.random(P) < 0.1] = -0.0
    h[:3] = [np.inf, -np.inf, 3.0e38]
    cell = rng.integers(0, L * L, P).astype(np.int32)
    valid = rng.random(P) < 0.9
    _, tb = _batches(L, h, np.ones(P, np.float32), cell, valid,
                     np.zeros(P, np.int32), np.arange(P, dtype=np.float32))
    offsets, hs, _, order, _ = tfs.sort_points(tb, L * L)
    ids = np.where(valid, cell, L * L)
    want = np.lexsort((np.arange(P), -np.where(valid, h, 0.0), ids))
    # the intensity payload carried the batch index
    np.testing.assert_array_equal(N(order).astype(np.int64),
                                  np.where(valid, np.arange(P), 0)[want])
    np.testing.assert_array_equal(
        N(offsets), np.searchsorted(ids[want], np.arange(L * L + 1)))


def _rows_oracle(offsets, h, v, inten, colf, elev0, var0, mcfg):
    """The 16 aggregate rows by a per-cell loop, as the CUDA kernel walks."""
    f32 = np.float32
    ncell = len(offsets) - 1
    out = np.zeros((16, ncell), np.float32)
    out[12:] = np.inf
    for c in range(ncell):
        lo, hi = offsets[c], offsets[c + 1]
        if hi == lo:
            continue
        st_h, st_v = h[lo], v[lo]
        empty = elev0[c] == f32(mcfg.invalid_elevation)
        ae = st_h if empty else elev0[c]
        av = max(st_v if empty else var0[c], f32(mcfg.min_variance))
        band = f32(mcfg.mahalanobis_threshold) * np.sqrt(av)
        W = WH = f32(0)
        vc = cm = im = f32(np.inf)
        out[0:3, c] = st_h, st_v, 1
        for i in range(lo, hi):
            inl = abs(h[i] - ae) <= band
            ci = int(colf[i])
            hc = ((ci >> 16) & 255) * ((ci >> 8) & 255) * (ci & 255) != 0 \
                and inten[i] != 0
            if inl:
                w = f32(1) / max(v[i], f32(1e-9))
                W, WH = W + w, WH + w * h[i]
                if hc:
                    if v[i] < vc:
                        vc, cm, im = v[i], colf[i], inten[i]
                    elif v[i] == vc:
                        cm, im = min(cm, colf[i]), min(im, inten[i])
            elif i == lo:
                out[6, c] = 1
                if hc:
                    out[7:11, c] = 1, v[i], colf[i], inten[i]
        out[4, c], out[5, c] = W, WH
        out[11, c] = h[hi - 1] + f32(3) * v[hi - 1]
        out[12:15, c] = vc, cm, im
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_rows_match_per_cell_loop(seed):
    rng = np.random.default_rng(20 + seed)
    L, P = 12, 700
    cfg = benchmark_config(length=L, max_points=P)
    _, ts = _states(rng, cfg.map, 0.5)
    cell = rng.integers(0, L * L // 3, P).astype(np.int32)
    h = (rng.integers(-6, 7, P) * 0.3).astype(np.float32)
    v = (rng.integers(1, 4, P) * 0.01).astype(np.float32)
    col = np.where(rng.random(P) < 0.5, rng.integers(1, 1 << 24, P),
                   0).astype(np.int32)
    inten = np.where(col != 0, rng.integers(1, 3, P), 0).astype(np.float32)
    _, tb = _batches(L, h, v, cell, rng.random(P) < 0.9, col, inten)
    srt = tfs.sort_points(tb, L * L)
    e0, v0 = ts.elevation.reshape(-1), ts.variance.reshape(-1)
    got = N(tfs.fuse_stream_aggregate(*srt, e0, v0, cfg.map))
    want = _rows_oracle(*[N(x) for x in srt], N(e0), N(v0), cfg.map)
    exact = [k for k in range(16) if k not in (4, 5)]
    np.testing.assert_array_equal(got[exact], want[exact])
    # W, WH: the same terms, summed by index_add in the same sorted order
    np.testing.assert_allclose(got[4:6], want[4:6], rtol=1e-6)
    assert (got[6] > 0).any() and (got[7] > 0).any() \
        and np.isfinite(got[12]).any()
