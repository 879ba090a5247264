"""The port's step over a leading robot axis (mapping/pipeline.py
`batched_step`, which `fleet_step` calls once per fleet frame) and its three
kernels' plain versions with a robot axis, against gem_tpu's functions under
`jax.vmap`, run as the JAX suite runs them on the CPU (Pallas in interpret
mode); and robot r of each batched plain call against the single-robot
call, bitwise.

Sizes are small: L <= 32, R = 3, P <= 512, uneven valid counts, one robot
colored.  Tolerances are those the single-robot tests pin:

  * K1 (tests/test_torch_fuse_stream.py): elevation, variance, intensity
    5e-6; color exact; lowest 1e-6.
  * K2 (tests/test_torch_features.py `_check`): counts and roughness
    exact; normal_z, slope and traver within the eigen-gap-scaled bound.
  * K3 (tests/test_torch_segment_stats.py `_check`): mins, maxs and
    n_spill exact; sums within 1e-6 of the sum of their terms' magnitudes.
  * The step (tests/test_torch_fleet.py `_check_robot`): elevation and
    variance rtol 1e-6, atol 1e-6; the submap bookkeeping exact; traver
    within the features bound.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gem_tpu.config as jconfig
from gem_tpu.core.state import init_map_state
from gem_tpu.io.replay import synthetic_frames as jframes
from gem_tpu.kernels import pallas_scatter as jps
from gem_tpu.kernels.features_pallas import compute_features_pallas
from gem_tpu.kernels.fuse_stream import fuse_stream as jfuse_stream
from gem_tpu.kernels.pointproc import PointBatch as JBatch
from gem_tpu.mapping import pipeline as jp
from gem_tpu.multirobot import fleet as jfleet

from gem_tpu_torch import config as tconfig
from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels import features as tft
from gem_tpu_torch.kernels import fuse as tfuse
from gem_tpu_torch.kernels import fuse_stream as tfs
from gem_tpu_torch.kernels import segment_stats as tss
from gem_tpu_torch.kernels.pointproc import PointBatch as TBatch
from gem_tpu_torch.mapping import pipeline as tp
from gem_tpu_torch.multirobot import fleet as tfleet
from gem_tpu_torch.utils.tree import tree_map

from test_torch_features import _check as _check_features
from test_torch_fleet import _cfg as _fleet_cfg
from test_torch_fleet import _check_robot
from test_torch_segment_stats import _check as _check_segments

R = 3
COUNTS = (420, 37, 260)     # valid points per robot: uneven


def T(a):
    return torch.from_numpy(np.array(a))


def _stack_jax(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _robot_states(rng, mcfg):
    """R map states, half fused, each with its own start: the JAX stack
    and the port's."""
    L = mcfg.length
    js = []
    for r in range(R):
        occ = rng.random((L, L)) < 0.5
        elev = np.where(occ, rng.normal(size=(L, L)),
                        mcfg.invalid_elevation).astype(np.float32)
        var = np.where(occ, rng.uniform(1e-4, 0.2, (L, L)),
                       mcfg.invalid_variance).astype(np.float32)
        js.append(init_map_state(mcfg).replace(
            elevation=jnp.asarray(elev), variance=jnp.asarray(var),
            start=jnp.asarray([(7 * r + 3) % L, (11 * r + 5) % L],
                              jnp.int32),
            lowest=jnp.asarray(rng.uniform(-1, 3, (L, L)).astype(
                np.float32)),
            color=jnp.asarray(rng.integers(0, 1 << 24, (L, L)), jnp.int32),
            intensity=jnp.asarray(rng.random((L, L)).astype(np.float32))))
    jstack = _stack_jax(js)
    ts = MapState(**{f.name: T(getattr(jstack, f.name))
                     for f in dataclasses.fields(MapState)})
    return jstack, ts


def _robot_batches(rng, L, P=512, colored=1):
    """(R, P) point batches, robot r with COUNTS[r] valid points and only
    robot `colored` carrying colors; the JAX and port batches."""
    valid = np.arange(P)[None, :] < np.asarray(COUNTS)[:, None]
    # crowd a few cells so that runs are long
    cell = np.where(rng.random((R, P)) < 0.3, rng.integers(0, 4, (R, P)),
                    rng.integers(0, L * L, (R, P)))
    cell = np.where(valid, cell, L * L).astype(np.int32)
    h = (rng.normal(size=(R, P)) * 2).astype(np.float32)
    v = rng.uniform(1e-4, 0.3, (R, P)).astype(np.float32)
    col = np.zeros((R, P), np.int32)
    col[colored] = np.where(rng.random(P) < 0.7,
                            rng.integers(1, 1 << 24, P), 0)
    inten = np.where(col != 0, rng.uniform(0.1, 1.0, (R, P)), 0.0).astype(
        np.float32)
    jb = JBatch(xy=jnp.zeros((R, P, 2)), height=jnp.asarray(h),
                variance=jnp.asarray(v), cell=jnp.asarray(cell),
                color=jnp.asarray(col), intensity=jnp.asarray(inten),
                valid=jnp.asarray(valid))
    tb = TBatch(xy=torch.zeros((R, P, 2)), height=T(h), variance=T(v),
                cell=T(cell), color=T(col), intensity=T(inten),
                valid=T(valid))
    return jb, tb


def _robot(tree, r):
    return tree_map(lambda x: x[r], tree)


def _k3_inputs(rng, S=300, n=512):
    """(R, n) unsorted ids (pad lanes S, uneven counts) and (F, R, n)
    columns per role."""
    ids = np.where(np.arange(n)[None, :] < np.asarray(COUNTS)[:, None],
                   rng.integers(0, S, (R, n)), S).astype(np.int32)
    sv, mv, xv = (rng.normal(size=(f, R, n)).astype(np.float32)
                  for f in (2, 2, 1))
    return ids, sv, mv, xv


def test_k1_fuse_stream_with_robot_axis_matches_jax_vmap():
    """`fuse_stream` over (R, L, L) states and (R, P) batches (one K1
    call; here its plain version) against `jax.vmap` of gem_tpu's
    `fuse_stream` in interpret mode, robot by robot."""
    rng = np.random.default_rng(1)
    cfg = jconfig.benchmark_config(length=24, max_points=512)
    js, ts = _robot_states(rng, cfg.map)
    jb, tb = _robot_batches(rng, 24)
    want = jax.jit(jax.vmap(lambda s, b: jfuse_stream(
        s, cfg, b, interpret=True)))(js, jb)
    got = tfs.fuse_stream(ts, cfg, tb)
    for r in range(R):
        for k in ("elevation", "variance", "intensity"):
            np.testing.assert_allclose(getattr(got, k)[r].numpy(),
                                       np.asarray(getattr(want, k)[r]),
                                       rtol=0, atol=5e-6, err_msg=(r, k))
        np.testing.assert_array_equal(got.color[r].numpy(),
                                      np.asarray(want.color[r]))
        np.testing.assert_allclose(got.lowest[r].numpy(),
                                   np.asarray(want.lowest[r]), rtol=0,
                                   atol=1e-6)
    assert (got.color[1] != ts.color[1]).any()      # the colored robot


def test_k2_features_with_robot_axis_match_jax_vmap():
    """`plane_fit_features` over an (R, L, L) stack with R starts (one K2
    call; here its plain version) against `jax.vmap` of
    `compute_features_pallas` in interpret mode, robot by robot."""
    rng = np.random.default_rng(2)
    cfg = jconfig.MapConfig(length=32, resolution=0.1)
    elev = rng.normal(size=(R, 32, 32)).astype(np.float32)
    elev[rng.random((R, 32, 32)) < np.array([0.1, 0.3, 0.6])[:, None,
                                                              None]] = \
        cfg.invalid_elevation
    starts = np.array([[0, 0], [13, 30], [31, 5]], np.int32)
    js = _stack_jax([init_map_state(cfg).replace(
        elevation=jnp.asarray(elev[r]), start=jnp.asarray(starts[r]))
        for r in range(R)])
    ts = MapState(**{f.name: T(getattr(js, f.name))
                     for f in dataclasses.fields(MapState)})
    want = jax.jit(jax.vmap(lambda s: compute_features_pallas(
        s, cfg, interpret=True)))(js)
    got = tft.plane_fit_features(ts, cfg)
    assert tuple(got.slope.shape) == (R, 32, 32)
    for r in range(R):
        _check_features(_robot(got, r), _robot(want, r), elev[r],
                        tuple(starts[r]), cfg)


def test_k3_segment_stats_with_robot_axis_match_jax_vmap():
    """`segment_stats` over (R, n) ids and (F, R, n) columns (each robot
    padded and sorted on its own, one K3 call per four columns; here its
    plain version) against `jax.vmap` of gem_tpu's `segment_stats` in
    Pallas interpret mode, robot by robot."""
    rng = np.random.default_rng(3)
    S, chunk, window = 300, 128, 256
    ids, sv, mv, xv = _k3_inputs(rng, S)
    move = lambda a: np.moveaxis(a, 1, 0)            # (R, F, n) for vmap
    want = jax.jit(jax.vmap(lambda *a: jps.segment_stats(
        *a, S, chunk=chunk, window=window, interpret=True)))(
        jnp.asarray(ids), *(jnp.asarray(move(a)) for a in (sv, mv, xv)))
    got = tss.segment_stats(T(ids), T(sv), T(mv), T(xv), S, chunk=chunk,
                            window=window)
    assert tuple(got[0].shape) == (2, R, S) and tuple(got[3].shape) == (R,)
    for r in range(R):
        _check_segments([np.asarray(w[r]) for w in want],
                        [g[:, r].numpy() for g in got[:3]]
                        + [got[3][r].numpy()],
                        ids[r], sv[:, r], mv[:, r], xv[:, r], S)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_plain_kernels_robot_r_is_the_single_call_bitwise(kernel):
    """Robot r of each batched plain kernel call is bitwise the call made
    for robot r alone (what the card's robot grid axis holds too)."""
    rng = np.random.default_rng(4)
    cfg = tconfig.benchmark_config(length=20, max_points=512)
    L = 20
    _, ts = _robot_states(rng, cfg.map)
    bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x
    if kernel == "K1":
        _, tb = _robot_batches(rng, L)
        args = lambda b, m: (*tfs.sort_points(b, L * L),
                             m.elevation.flatten(-2), m.variance.flatten(-2),
                             cfg.map)
        got = tfs.fuse_stream_aggregate_plain(*args(tb, ts))
        ones = [tfs.fuse_stream_aggregate_plain(*args(_robot(tb, r),
                                                      _robot(ts, r)))
                for r in range(R)]
        pairs = [(got[r], ones[r]) for r in range(R)]
        assert bool(torch.isfinite(got[:, 4]).all())
    elif kernel == "K2":
        got = tft.compute_features(ts, cfg.map)
        pairs = [(getattr(got, k)[r], getattr(tft.compute_features(
            _robot(ts, r), cfg.map), k)) for r in range(R)
            for k in ("slope", "rough", "traver", "normal_z",
                      "neighbor_count")]
    else:
        ids, sv, mv, xv = _k3_inputs(rng)
        ids_s, cols = tss.pad_sort(T(ids), T(np.concatenate([sv, mv, xv])),
                                   300)
        got = tss.segment_stats_sorted_plain(ids_s, cols[:2], cols[2:4],
                                             cols[4:], 300)
        pairs = []
        for r in range(R):
            one = tss.segment_stats_sorted_plain(
                ids_s[r], cols[:2, r], cols[2:4, r], cols[4:, r], 300)
            pairs += [(g[:, r], o) for g, o in zip(got, one)]
    for a, b in pairs:
        assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("backend,want", [
    ("stream", {"K1": 1, "K2": 1, "K3": 0}),
    ("pallas", {"K1": 0, "K2": 1, "K3": 5})])
def test_fleet_step_reaches_each_kernel_wrapper_once_per_frame(
        backend, want, monkeypatch):
    """`fleet_step` over 3 robots calls K1's and K2's wrappers once per
    fleet frame (stream) or K3's five times and K2's once (pallas): the
    robots ride the kernels' grid axis, not a loop."""
    calls = {"K1": 0, "K2": 0, "K3": 0}

    def spy(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(tfs, "fuse_stream_aggregate",
                        spy("K1", tfs.fuse_stream_aggregate))
    monkeypatch.setattr(tp, "plane_fit_features",
                        spy("K2", tp.plane_fit_features))
    monkeypatch.setattr(tfuse, "segment_stats_sorted",
                        spy("K3", tfuse.segment_stats_sorted))
    cfg = tconfig.benchmark_config(length=24, max_points=512)
    state = tfleet.make_fleet_state(cfg, R, device="cpu")
    T_ = 2
    gens = [tp.frame_from_numpy(f, "cpu") for r in range(R)
            for f, _, _ in jframes(cfg, T_, n_points=COUNTS[r], seed=r)]
    for t in range(T_):
        frames = tfleet.stack_frames([gens[r * T_ + t] for r in range(R)])
        state, _ = tfleet.fleet_step(state, frames, cfg, fuse_backend=backend)
    assert calls == {k: v * T_ for k, v in want.items()}


def test_batched_step_matches_jax_vmap_step_segment():
    """`batched_step` (segment fuse, the configuration of JAX's
    `fleet_step`) against `jax.vmap` of gem_tpu's `step` over 3 robots
    with uneven streams and speeds, robot 1 colored, frame by frame."""
    cfg_j = _fleet_cfg(jconfig, raytrace=False)
    cfg_t = _fleet_cfg(tconfig, raytrace=False)
    cfg_j = cfg_j.replace(map=dataclasses.replace(cfg_j.map, length=32))
    cfg_t = cfg_t.replace(map=dataclasses.replace(cfg_t.map, length=32))
    T_ = 4
    rng = np.random.default_rng(7)
    streams = []
    for r in range(R):
        fr = [f for f, _, _ in jframes(cfg_j, T_, n_points=COUNTS[r],
                                       speed=0.3 + 0.15 * r, seed=40 + r)]
        if r == 1:
            fr = [dataclasses.replace(f, colors=np.where(
                rng.random(cfg_j.max_points) < 0.8,
                rng.integers(1, 1 << 24, cfg_j.max_points), 0).astype(
                np.int32)) for f in fr]
        streams.append(fr)
    jf = jax.jit(jax.vmap(functools.partial(jp.step, cfg=cfg_j)))
    js = jfleet.make_fleet_state(cfg_j, R)
    ts = tfleet.make_fleet_state(cfg_t, R, device="cpu")
    for t in range(T_):
        frames = [streams[r][t] for r in range(R)]
        js, jo = jf(js, jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *frames))
        ts, to = tp.batched_step(ts, tfleet.stack_frames(
            [tp.frame_from_numpy(f, "cpu") for f in frames]), cfg_t,
            fuse_backend="segment")
        a, b = tp.state_to_numpy(ts), jax.tree.map(np.asarray, js)
        for r in range(R):
            _check_robot(a, b, to, jo, cfg_j, r, f"frame {t}")
            np.testing.assert_array_equal(a.map.color[r], b.map.color[r])
        np.testing.assert_array_equal(to.metrics["points_valid"].numpy(),
                                      np.asarray(jo.metrics["points_valid"]))
    assert (ts.map.color[1] != 0).any()
