"""The port's segment statistics (gem_tpu_torch/kernels/segment_stats.py,
the module of kernel K3) against gem_tpu/kernels/pallas_scatter.py run in
Pallas interpret mode, over the cases of tests/test_pallas_scatter.py.

Tolerances: mins and maxs exactly (selections); sums within 1e-6 of the
sum of the terms' magnitudes per segment (JAX adds through one-hot matmuls
chunk by chunk, plus the spill fallback, the port in sorted order);
`n_spill`, the TPU window's diagnostic count, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.kernels import pallas_scatter as jps

from gem_tpu_torch.kernels import segment_stats as tss


def _numpy_ref(ids, sv, mv, xv, S):
    sums = np.zeros((sv.shape[0], S), np.float64)
    mags = np.zeros((sv.shape[0], S), np.float64)
    mins = np.full((mv.shape[0], S), np.inf, np.float32)
    maxs = np.full((xv.shape[0], S), -np.inf, np.float32)
    for i, s in enumerate(ids):
        if s >= S:
            continue
        sums[:, s] += sv[:, i]
        mags[:, s] += np.abs(sv[:, i])
        mins[:, s] = np.minimum(mins[:, s], mv[:, i])
        maxs[:, s] = np.maximum(maxs[:, s], xv[:, i])
    return sums, mags, mins, maxs


def _run_both(ids, sv, mv, xv, S, chunk, window):
    want = jax.jit(lambda *a: jps.segment_stats(
        *a, S, chunk=chunk, window=window, interpret=True))(
        jnp.asarray(ids), jnp.asarray(sv), jnp.asarray(mv), jnp.asarray(xv))
    got = tss.segment_stats(*(torch.from_numpy(a) for a in (ids, sv, mv, xv)),
                            S, chunk=chunk, window=window)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _check(want, got, ids, sv, mv, xv, S):
    ref_s, mags, ref_m, ref_x = _numpy_ref(ids, sv, mv, xv, S)
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], ref_m)
    np.testing.assert_array_equal(got[2], ref_x)
    assert np.all(np.abs(got[0] - want[0]) <= 1e-6 * mags)
    assert np.all(np.abs(got[0] - ref_s) <= 1e-6 * mags)
    assert int(got[3]) == int(want[3])


@pytest.mark.parametrize("clustered", [True, False])
def test_segment_stats_matches_jax(clustered):
    rng = np.random.default_rng(0)
    n, S = 1024, 4096
    if clustered:
        ids = np.sort(rng.integers(0, 600, n)).astype(np.int32)
    else:
        # scattered ids over the whole range: the TPU window spills
        ids = rng.integers(0, S + 1, n).astype(np.int32)
    sv = rng.normal(size=(2, n)).astype(np.float32)
    mv = rng.normal(size=(2, n)).astype(np.float32)
    xv = rng.normal(size=(1, n)).astype(np.float32)
    want, got = _run_both(ids, sv, mv, xv, S, chunk=256, window=512)
    _check(want, got, ids, sv, mv, xv, S)
    assert (int(got[3]) > 0) == (not clustered)


def test_all_invalid():
    n, S = 256, 128
    ids = np.full((n,), S, np.int32)
    z = np.zeros((1, n), np.float32)
    want, got = _run_both(ids, z, z, z, S, chunk=128, window=256)
    assert np.abs(got[0]).max() == 0.0
    assert np.isinf(got[1]).all() and np.isneginf(got[2]).all()
    assert int(got[3]) == int(want[3]) == 0


def test_segment_stats_sorted_keeps_every_point():
    """Ids the TPU window spills are still reduced (no fallback pass): the
    sorted entry point equals the plain reduction, and `n_spill` counts
    what JAX's window would have spilled."""
    rng = np.random.default_rng(4)
    n, S = 2048, 50_000
    ids = np.sort(rng.integers(0, S, n)).astype(np.int32)
    cols = rng.normal(size=(3, n)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (ids, cols[:1], cols[1:2], cols[2:])]
    sums, mins, maxs, n_spill = tss.segment_stats_sorted(*t, S, chunk=512,
                                                         window=1024)
    ref_s, mags, ref_m, ref_x = _numpy_ref(ids, cols[:1], cols[1:2],
                                           cols[2:], S)
    assert int(n_spill) > 0
    np.testing.assert_array_equal(mins.numpy(), ref_m)
    np.testing.assert_array_equal(maxs.numpy(), ref_x)
    assert np.all(np.abs(sums.numpy() - ref_s) <= 1e-6 * mags)
    bases = np.repeat(ids[::512] // 128 * 128, 512)
    assert int(n_spill) == int(((ids - bases >= 1024) & (ids < S)).sum())
    # fuse_pallas's call: the same statistics, no spill count
    *stats, none = tss.segment_stats_sorted(*t, S, with_spill=False)
    assert none is None
    for a, b in zip(stats, (sums, mins, maxs)):
        assert torch.equal(a, b)


def test_pad_sort_is_one_stable_sort():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 40, 1000).astype(np.int32)
    cols = np.stack([np.arange(1000, dtype=np.float32),
                     rng.normal(size=1000).astype(np.float32)])
    ji, jc = jps.pad_sort(jnp.asarray(ids), jnp.asarray(cols), 40, chunk=256)
    ti, tc = tss.pad_sort(torch.from_numpy(ids), torch.from_numpy(cols), 40,
                          chunk=256)
    assert ti.shape == (1024,) and tc.shape == (2, 1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("roles", [(0, 0, 1), (0, 2, 0), (2, 0, 1),
                                   (0, 0, 0)])
def test_empty_roles_give_empty_results(roles):
    """A (0, N) stack for a role returns a (0, S) result, and the other
    roles' results equal those of a call with every role filled: what
    `fuse_pallas` passes for the roles whose results it drops."""
    rng = np.random.default_rng(11)
    n, S = 3000, 900
    ids = np.sort(np.where(rng.random(n) < 0.9, rng.integers(0, S, n), S))
    t_ids = torch.from_numpy(ids.astype(np.int32))
    full = [torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
            for _ in range(3)]
    cols = [c[:f] for c, f in zip(full, roles)]
    got = tss.segment_stats_sorted(t_ids, *cols, S, with_spill=False)
    want = tss.segment_stats_sorted(t_ids, *full, S, with_spill=False)
    for g, w, f in zip(got[:3], want[:3], roles):
        assert tuple(g.shape) == (f, S)
        assert torch.equal(g, w[:f])
