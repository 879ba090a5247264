"""The port's loop-closure re-stitch (gem_tpu_torch/global_map/loop_closure.py)
against gem_tpu's.

Inputs sit at cell centers (x = (k + 0.5) * res), so the ceil cell keys do
not depend on the last bit of a coordinate.  Key counts (`n_pairs`,
`n_rounds`, `n_cells_fused`) must be equal; re-fused z and variance within
1e-6 relative: XLA's CPU code generator contracts `a * b + c` into one FMA
inside the jitted re-fusion, PyTorch rounds the product first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.config import MapConfig, PipelineConfig, SubmapConfig
from gem_tpu.global_map import loop_closure as jlc
from gem_tpu.global_map import submaps as jsm

from gem_tpu_torch.global_map import loop_closure as tlc
from gem_tpu_torch.global_map import submaps as tsm

_FIELDS = ("x", "y", "z", "variance", "intensity", "traver", "color",
           "valid")


def _cfg(K=4, C=128, **kw):
    return PipelineConfig(
        map=MapConfig(length=16, resolution=0.5, max_shift_cells=4),
        submap=SubmapConfig(max_submaps=K, capacity=C, keyframe_distance=2.0,
                            overlap_radius=25.0, store_ortho=False,
                            keyframe_scan_points=0, **kw))


def _buffers(rng, shape, res, n_valid, span=8):
    """Cell-center points with repeated cells, variances partly outside
    (0, 1) (the gate), and invalid rows past n_valid."""
    C = shape[-1]
    f = {"x": (rng.integers(-span, span, shape) + 0.5) * res,
         "y": (rng.integers(-span, span, shape) + 0.5) * res,
         "z": rng.normal(0, 1, shape),
         "variance": rng.uniform(0.02, 1.3, shape),
         "intensity": rng.normal(size=shape), "traver": rng.random(shape)}
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["color"] = rng.integers(0, 1 << 24, shape).astype(np.int32)
    f["valid"] = np.broadcast_to(np.arange(C) < n_valid, shape).copy()
    return f


def _jbuf(f):
    return jsm.PointBuffer(**{k: jnp.asarray(f[k]) for k in _FIELDS})


def _tbuf(f):
    return tsm.PointBuffer(**{k: torch.from_numpy(np.array(f[k]))
                              for k in _FIELDS})


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def _assert_store(t, j, exact=("x", "y", "intensity", "traver", "color",
                               "valid")):
    for k in exact:
        np.testing.assert_array_equal(getattr(t.slots, k).numpy(),
                                      np.asarray(getattr(j.slots, k)), k)
    for k in ("z", "variance"):
        _close(getattr(t.slots, k), getattr(j.slots, k), k)


@pytest.mark.parametrize("res,seed", [(0.5, 0), (0.1, 1), (0.2, 2)])
def test_refuse_pair_matches_jax(res, seed):
    rng = np.random.default_rng(seed)
    fa, fb = (_buffers(rng, (96,), res, n, span=6) for n in (80, 70))
    ja, jb, jn = jlc.refuse_pair(_jbuf(fa), _jbuf(fb), res)
    ta, tb, tn = tlc.refuse_pair(_tbuf(fa), _tbuf(fb), res)
    assert int(tn) == int(jn) > 10
    for t, j in ((ta, ja), (tb, jb)):
        for k in ("z", "variance"):
            _close(getattr(t, k), getattr(j, k), k)
        np.testing.assert_array_equal(t.x.numpy(), np.asarray(j.x))


def test_refuse_pair_kalman_fusion():
    """The JAX suite's worked example: one co-located cell fuses to the
    intended Kalman form, the rest pass through."""
    C = 16
    mk = lambda xs, zs, vs: tsm.PointBuffer(
        x=torch.tensor(np.resize(np.asarray(xs, np.float32), C)),
        y=torch.zeros(C),
        z=torch.tensor(np.resize(np.asarray(zs, np.float32), C)),
        variance=torch.tensor(np.resize(np.asarray(vs, np.float32), C)),
        intensity=torch.zeros(C), traver=torch.zeros(C),
        color=torch.zeros(C, dtype=torch.int32),
        valid=torch.arange(C) < len(xs))
    a2, b2, nf = tlc.refuse_pair(mk([1.0, 3.0], [0.0, 1.0], [0.1, 0.2]),
                                 mk([1.0, 9.0], [2.0, 5.0], [0.3, 0.1]), 0.5)
    assert int(nf) == 1
    assert float(a2.z[0]) == pytest.approx(0.5, rel=1e-5)
    assert float(b2.z[0]) == pytest.approx(0.5, rel=1e-5)
    assert float(a2.variance[0]) == pytest.approx(0.075, rel=1e-5)
    assert float(a2.z[1]) == 1.0 and float(b2.z[1]) == 5.0


def test_quantize_matches_jax_at_cell_boundaries():
    """ceil(x / res) under the reference's jit is ceil(x * f32(1/res)): at
    exact multiples of the resolution the two can differ, and the port must
    take the reference's side."""
    res = 0.1
    k = np.arange(-400, 400, dtype=np.float32)
    x = np.concatenate([k * np.float32(res),
                        np.nextafter(k * np.float32(res), np.float32(1e9)),
                        np.nextafter(k * np.float32(res), np.float32(-1e9))])
    x = x[np.abs(x) > 1e-30]      # XLA's CPU flushes denormals to zero
    jq = jax.jit(lambda a: jlc._quantize(a, a, res))(jnp.asarray(x))
    tq = tlc._quantize(torch.from_numpy(x), torch.from_numpy(x), res)
    np.testing.assert_array_equal(tq[0].numpy(), np.asarray(jq[0]))
    # and true division would not: the fold decides some keys here
    div = np.ceil(x / np.float32(res)).astype(np.int32)
    assert (div != np.asarray(jq[0])).any()


def _slots(rng, K, C, res, n_valid):
    f = _buffers(rng, (K, C), res, n_valid)
    return f, _jbuf(f), _tbuf(f)


def test_refuse_rounds_equals_the_sequential_chain():
    """Rounds of vertex-disjoint pairs: the port's batched rounds equal its
    own sequential refuse_pair chain taken in round-major order bitwise, and
    the reference's rounds to 1e-6."""
    K, C, res = 6, 48, 0.5
    rng = np.random.default_rng(4)
    f, js, ts = _slots(rng, K, C, res, 36)
    pairs = [(0, 1), (1, 0), (1, 2), (0, 2), (2, 3), (3, 4), (4, 5), (2, 0)]
    rounds, valid = tlc.schedule_rounds(pairs)
    jr, jv = jlc.schedule_rounds(pairs)
    np.testing.assert_array_equal(rounds, jr)
    np.testing.assert_array_equal(valid, jv)
    assert rounds.shape[0] > 1

    seq = {k: getattr(ts, k).clone() for k in _FIELDS}
    total = 0
    for r in range(rounds.shape[0]):
        for p in range(rounds.shape[1]):
            if not valid[r, p]:
                continue
            i, j = (int(v) for v in rounds[r, p])
            a = tsm.PointBuffer(**{k: seq[k][i] for k in _FIELDS})
            b = tsm.PointBuffer(**{k: seq[k][j] for k in _FIELDS})
            a2, b2, nf = tlc.refuse_pair(a, b, res)
            for k in ("z", "variance"):
                seq[k][i] = getattr(a2, k)
                seq[k][j] = getattr(b2, k)
            total += int(nf)

    got, nf = tlc.refuse_rounds(ts, rounds, valid, res)
    assert int(nf) == total > 0
    for k in ("z", "variance"):
        assert torch.equal(getattr(got, k), seq[k]), k
    want, jnf = jlc.refuse_rounds(js, jnp.asarray(rounds), jnp.asarray(valid),
                                  res)
    assert int(jnf) == total
    for k in ("z", "variance"):
        _close(getattr(got, k), getattr(want, k), k)


def test_refuse_pairs_matches_jax():
    """The sequential pair sweep with padding lanes, where consecutive pairs
    share a submap: the same fused-cell count as the reference's scan, z and
    variance to 1e-6."""
    K, C, res = 4, 40, 0.5
    rng = np.random.default_rng(6)
    f, js, ts = _slots(rng, K, C, res, 30)
    pairs = np.zeros((8, 2), np.int32)
    pairs[:5] = [(0, 1), (1, 2), (0, 2), (2, 3), (3, 0)]
    valid = np.arange(8) < 5
    got, nf = tlc.refuse_pairs(ts, pairs, valid, res)
    want, jnf = jlc.refuse_pairs(js, jnp.asarray(pairs), jnp.asarray(valid),
                                 res)
    assert int(nf) == int(jnf) > 0
    for k in ("z", "variance"):
        _close(getattr(got, k), getattr(want, k), k)
    np.testing.assert_array_equal(got.x.numpy(), f["x"])


def test_relative_transforms_match_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(8, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opt = np.concatenate([rng.normal(0, 20, (8, 3)), q], 1).astype(np.float32)
    q2 = q + rng.normal(0, 0.05, q.shape)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    traj = np.concatenate([opt[:, :3] + rng.normal(0, 1, (8, 3)), q2],
                          1).astype(np.float32)
    want = np.asarray(jlc.relative_transforms(opt, traj))
    got = tlc.relative_transforms(torch.from_numpy(opt),
                                  torch.from_numpy(traj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    eye = tlc.relative_transforms(torch.from_numpy(opt),
                                  torch.from_numpy(opt)).numpy()
    # a few f32 ULPs of the 20 m translations
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                               atol=1e-5)


def _finalized(cfg, n_total, points, poses):
    """The same finalize_submap sequence in both packages."""
    js, ts = jsm.init_store(cfg), tsm.init_store(cfg, "cpu")
    for i in range(n_total):
        f = {k: v[i] for k, v in points.items()}
        js = jsm.finalize_submap(js, _jbuf(f), jnp.asarray(poses[i]))
        ts = tsm.finalize_submap(ts, _tbuf(f), torch.from_numpy(poses[i]))
    return js, ts


def _one_point_rows(n_total, x0=10.0):
    return {"x": np.arange(n_total, dtype=np.float32)[:, None] + x0,
            "y": np.zeros((n_total, 1), np.float32),
            "z": np.ones((n_total, 1), np.float32),
            "variance": np.full((n_total, 1), 0.01, np.float32),
            "intensity": np.zeros((n_total, 1), np.float32),
            "traver": np.full((n_total, 1), 0.5, np.float32),
            "color": np.zeros((n_total, 1), np.int32),
            "valid": np.ones((n_total, 1), bool)}


@pytest.mark.parametrize("n_opt,shift", [(6, 100.0), (4, 50.0)])
def test_loop_closure_after_ring_wrap(n_opt, shift):
    """Six keyframes through a 4-slot ring (slots hold ids [4, 5, 2, 3]):
    optimised poses are trajectory-indexed and matched through kf_ids; with
    a short opt_poses only the resident ids below its length move."""
    cfg = _cfg()
    poses = np.zeros((6, 7), np.float32)
    poses[:, 0] = np.arange(6)
    poses[:, 3] = 1.0
    js, ts = _finalized(cfg, 6, _one_point_rows(6), poses)
    assert ts.kf_ids.tolist() == [4, 5, 2, 3]
    opt = np.zeros((n_opt, 7), np.float32)
    opt[:, 3] = 1.0
    opt[:, 0] = np.arange(n_opt) + (shift * np.arange(n_opt) if n_opt == 6
                                    else shift)
    jn, jstats = jlc.apply_loop_closure(js, cfg, opt)
    tn, tstats = tlc.apply_loop_closure(ts, cfg, opt)
    assert tstats == jstats
    assert tstats["n_corrected"] == (4 if n_opt == 6 else 2)
    np.testing.assert_allclose(tn.slots.x.numpy(), np.asarray(jn.slots.x),
                               atol=1e-4)
    np.testing.assert_array_equal(tn.poses.numpy(), np.asarray(jn.poses))
    np.testing.assert_array_equal(tn.centers.numpy(), np.asarray(jn.centers))
    for s, i in enumerate(tn.kf_ids.tolist()):
        moved = (shift * i if n_opt == 6 else shift) if i < n_opt else 0.0
        assert abs(float(tn.slots.x[s, 0]) - (10.0 + i + moved)) < 1e-4


def test_loop_closure_nothing_to_correct():
    cfg = _cfg()
    js, ts = jsm.init_store(cfg), tsm.init_store(cfg, "cpu")
    opt = np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32), (3, 1))
    assert tlc.apply_loop_closure(ts, cfg, opt)[1] \
        == jlc.apply_loop_closure(js, cfg, opt)[1] \
        == {"n_corrected": 0, "n_pairs": 0, "n_cells_fused": 0}


def test_loop_closure_k32_dense_blob():
    """K = 32 submaps in a 20 m blob (every pair overlaps, capped at the
    nearest 8): the pair list, round schedule and fused-cell count equal
    the reference's; drift corrections are whole cells, so every point
    stays at a cell center."""
    K, C, res = 32, 64, 0.5
    cfg = _cfg(K=K, C=C)
    rng = np.random.default_rng(0)
    f = _buffers(rng, (K, C), res, 56)
    centers = rng.uniform(-10, 10, (K, 2))
    poses = np.zeros((K, 7), np.float32)
    poses[:, :2] = centers
    poses[:, 3] = 1.0
    js, ts = _finalized(cfg, K, f, poses)
    opt = poses.copy()
    opt[:, 0] += res * rng.integers(-2, 3, K)
    opt[:, 1] += res * rng.integers(-2, 3, K)
    jn, jstats = jlc.apply_loop_closure(js, cfg, opt)
    tn, tstats = tlc.apply_loop_closure(ts, cfg, opt)
    assert tstats == jstats
    assert tstats["n_pairs"] == K * 8 and tstats["n_cells_fused"] > 100
    np.testing.assert_array_equal(tn.kf_ids.numpy(), np.asarray(jn.kf_ids))
    _assert_store(tn, jn, exact=("intensity", "traver", "color", "valid"))
    np.testing.assert_allclose(tn.slots.x.numpy(), np.asarray(jn.slots.x),
                               atol=1e-5)


def _lapped_ring(n=64, step=11.0, lap=320.0):
    """Slot centres `step` m apart along a circuit of `lap` m, lapped: the
    re-stitch cell's ring, where every cap of 8 binds."""
    r = lap / (2 * np.pi)
    s = np.arange(n) * step
    return np.stack([r * np.cos(s / r), r * np.sin(s / r)],
                    axis=1).astype(np.float32)


def _select_case(case):
    """(centers, radius, caps)."""
    rng = np.random.default_rng(7)
    if case == "line":
        return np.stack([np.arange(8.0), np.zeros(8)], axis=1), 3.5, \
            (100, 8, 2)
    if case == "ties":
        # a grid: many neighbours at exactly equal distances, cut by the cap
        g = np.stack(np.meshgrid(np.arange(6), np.arange(5)), -1)
        return g.reshape(-1, 2).astype(np.float32), 2.5, (1, 3, 4, 7)
    if case == "random_capped":
        return rng.uniform(-10, 10, (40, 2)).astype(np.float32), 9.0, \
            (0, 1, 5)
    if case == "random_slack":
        return rng.uniform(-30, 30, (40, 2)).astype(np.float32), 6.0, \
            (40, 1000)
    if case == "lapped_ring":
        return _lapped_ring(), 25.0, (8,)
    if case == "tiny":
        return np.zeros((1, 2), np.float32), 1.0, (8,)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["line", "ties", "random_capped",
                                  "random_slack", "lapped_ring", "tiny"])
def test_select_pairs_is_the_reference_s(case):
    """The array-op selection equals the reference's loops: the same list
    of (int, int) tuples, i-major, j ascending, the nearest M kept with
    ties in j order."""
    centers, radius, caps = _select_case(case)
    for cap in caps:
        got = tlc.select_pairs(centers, radius, cap)
        want = jlc.select_pairs(centers, radius, cap)
        assert got == want
        assert type(got) is list
        assert all(type(p) is tuple and all(type(v) is int for v in p)
                   for p in got)
    if case == "line":
        capped = tlc.select_pairs(centers, 3.5, 2)
        assert [j for i, j in capped if i == 4] == [3, 5]
    if case == "ties":
        # the cap binds inside a run of equal distances
        assert len(tlc.select_pairs(centers, radius, 3)) \
            < len(tlc.select_pairs(centers, radius, 100))
    if case == "lapped_ring":
        assert len(tlc.select_pairs(centers, radius, 8)) == 64 * 8


def _schedule_case(case):
    rng = np.random.default_rng(11)
    if case == "empty":
        return []
    if case == "one_pair":
        return [(3, 1)]
    if case == "a_slot_in_every_pair":
        # more rounds than one 64-bit mask holds
        return [(5, int(j)) for j in rng.integers(0, 90, 150)]
    if case == "random":
        return [tuple(int(v) for v in rng.integers(0, 12, 2))
                for _ in range(70)]
    if case == "lapped_ring":
        return jlc.select_pairs(_lapped_ring(), 25.0, 8)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["empty", "one_pair", "a_slot_in_every_pair",
                                  "random", "lapped_ring"])
def test_schedule_rounds_is_the_reference_s(case):
    """The bitmask first-fit gives the reference's rounds and valid bit for
    bit (dtype, power-of-two padding), from a list or an array of pairs."""
    pairs = _schedule_case(case)
    want = jlc.schedule_rounds(pairs)
    for given in (pairs, np.asarray(pairs, np.int64).reshape(-1, 2)):
        got = tlc.schedule_rounds(given)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    if case == "lapped_ring":
        assert len(pairs) == 512 and want[1].any(axis=1).sum() == 22
    if case == "a_slot_in_every_pair":
        assert want[0].shape[0] == 256


@pytest.mark.parametrize("case", ["empty", "one_pair", "a_slot_in_every_pair",
                                  "random", "lapped_ring"])
def test_first_fit_fallback_is_the_native_library_s(case, monkeypatch):
    """`native.first_fit_rounds` without its library (the Python fallback)
    gives the library's rounds, lanes and counts, and `schedule_rounds`
    through it the reference's arrays; both refuse a negative slot."""
    from gem_tpu_torch import native

    assert native.available()
    pairs = np.asarray(_schedule_case(case), np.int32).reshape(-1, 2)
    want = jlc.schedule_rounds(_schedule_case(case))
    got = {}
    for path in ("library", "fallback"):
        if path == "fallback":
            monkeypatch.setattr(native, "_load", lambda: None)
        got[path] = native.first_fit_rounds(pairs)
        for g, w in zip(tlc.schedule_rounds(pairs), want):
            np.testing.assert_array_equal(g, w)
        with pytest.raises(ValueError):
            native.first_fit_rounds([(0, -1)])
    (lr, ll, *lc), (fr, fl, *fc) = got["library"], got["fallback"]
    assert lr.dtype == fr.dtype == ll.dtype == fl.dtype == np.int32
    np.testing.assert_array_equal(lr, fr)
    np.testing.assert_array_equal(ll, fl)
    assert lc == fc == [want[1].any(axis=1).sum(),
                        want[1].sum(axis=1).max(initial=0)]


def test_slot_corrections_match_jax():
    cfg = _cfg()
    poses = np.zeros((6, 7), np.float32)
    poses[:, 0] = np.arange(6)
    poses[:, 3] = 1.0
    js, ts = _finalized(cfg, 6, _one_point_rows(6), poses)
    opt = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)
    for a, b in zip(tlc.slot_corrections(ts, opt),
                    jlc.slot_corrections(js, opt)):
        np.testing.assert_array_equal(a, b)


def test_pose_to_matrix_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=4)
    p = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)]) \
        .astype(np.float32)
    np.testing.assert_allclose(
        tlc.pose_to_matrix(torch.from_numpy(p)).numpy(),
        np.asarray(jlc.pose_to_matrix(jnp.asarray(p))), atol=1e-7)

