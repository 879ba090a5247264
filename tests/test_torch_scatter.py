"""The port's segment-reduce primitives (gem_tpu_torch/kernels/scatter.py)
against gem_tpu/kernels/scatter.py, backend for backend.

Tolerances: min, max, counts and argmin/argmax exactly (selections); sums
of the segment backend exactly (both add each segment's terms in point
order); sums of the sort backend within 1e-6 of the sum of the terms'
magnitudes over the whole prefix (a global cumsum minus the carry at the
run start: XLA's cumsum on the CPU is an associative scan, torch's a
sequential one, so the rounding of the large prefix differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.kernels import scatter as js

from gem_tpu_torch.kernels import scatter as tsc


def _case(seed, n=3000, S=400, dtype=np.float32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S + 40, n).astype(np.int32)     # ~9% dropped
    ids[rng.random(n) < 0.05] = S                          # pad id
    if dtype == np.int32:
        vals = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    else:
        vals = (rng.normal(size=n) * 3).astype(np.float32)
        vals[rng.random(n) < 0.1] = 0.5                    # exact ties
    return ids, vals, S


@pytest.mark.parametrize("backend", ["segment", "sort"])
@pytest.mark.parametrize("kind,fill,dtype", [
    ("sum", 0.0, np.float32), ("min", np.inf, np.float32),
    ("max", -np.inf, np.float32), ("min", -10.0, np.float32),
    ("max", 7.0, np.float32), ("min", np.iinfo(np.int32).max, np.int32),
    ("max", 0, np.int32), ("sum", 0, np.int32)])
def test_segment_reduce_matches_jax(backend, kind, fill, dtype):
    ids, vals, S = _case(len(kind) + int(np.isfinite(fill)), dtype=dtype)
    want = np.asarray(jax.jit(lambda v, i: js.segment_reduce(
        v, i, S, kind, fill, backend=backend))(vals, ids))
    got = tsc.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids),
                             S, kind, fill, backend=backend).numpy()
    assert got.dtype == want.dtype and got.shape == (S,)
    if kind == "sum" and backend == "sort" and dtype == np.float32:
        bound = 1e-6 * np.abs(vals[ids < S]).sum()
        np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    else:
        np.testing.assert_array_equal(got, want)


def test_sorted_segments_share_one_sort():
    ids, vals, S = _case(3)
    ss_t = tsc.SortedSegments(torch.from_numpy(ids), S)
    ss_j = js.SortedSegments(jnp.asarray(ids), S)
    np.testing.assert_array_equal(ss_t.order.numpy(), np.asarray(ss_j.order))
    for attr in ("is_start", "is_end", "valid"):
        np.testing.assert_array_equal(getattr(ss_t, attr).numpy(),
                                      np.asarray(getattr(ss_j, attr)))
    v = torch.from_numpy(vals)
    for kind, fill in (("max", -np.inf), ("min", np.inf)):
        a = tsc.segment_reduce(v, None, S, kind, fill, backend="sort",
                               ss=ss_t)
        b = tsc.segment_reduce(v, torch.from_numpy(ids), S, kind, fill)
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["segment", "sort"])
def test_segment_count_matches_jax(backend):
    ids, _, S = _case(5)
    want = np.asarray(jax.jit(lambda i: js.segment_count(
        i, S, backend=backend))(ids))
    got = tsc.segment_count(torch.from_numpy(ids), S, backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["min", "max"])
def test_segment_argminmax_matches_jax(kind):
    ids, vals, S = _case(7)
    valid = np.random.default_rng(8).random(ids.shape[0]) < 0.8
    want = np.asarray(js.segment_argminmax(
        jnp.asarray(vals), jnp.asarray(ids), S, kind,
        valid=jnp.asarray(valid)))
    got = tsc.segment_argminmax(torch.from_numpy(vals), torch.from_numpy(ids),
                                S, kind, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any() and (want >= 0).any()


def test_all_ids_dropped():
    ids = torch.full((64,), 50, dtype=torch.int32)
    v = torch.ones(64)
    for backend in ("segment", "sort"):
        assert torch.equal(tsc.segment_reduce(v, ids, 50, "sum", 0.0,
                                              backend=backend),
                           torch.zeros(50))
        assert bool(torch.isinf(tsc.segment_reduce(
            v, ids, 50, "min", float("inf"), backend=backend)).all())
