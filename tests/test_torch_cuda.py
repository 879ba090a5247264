"""The CUDA kernel wrappers: K1 `fuse_stream_aggregate`, K2
`plane_fit_features` and K3 `segment_stats_sorted`.

This file imports no jax, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tests that need the card take the `cuda` fixture and skip without one.  On
the card each kernel is held against its plain PyTorch version: selection
outputs bitwise, K1's two gated sums W and WH and K3's sums (f32 sums that
the plain version adds with atomics in no fixed order) to 1e-5 relative,
and K2's five planes bitwise.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gem_tpu_torch.config import benchmark_config
from gem_tpu_torch.core.state import init_map_state
from gem_tpu_torch.kernels import features as ft
from gem_tpu_torch.kernels import fuse_stream as fs
from gem_tpu_torch.kernels import segment_stats as sst
from gem_tpu_torch.kernels.pointproc import PointBatch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _inputs(L, P, device, seed=0):
    rng = np.random.default_rng(seed)
    cfg = benchmark_config(length=L, max_points=P)
    m = init_map_state(cfg.map, "cpu")
    occ = rng.random((L, L)) < 0.5
    elev = np.where(occ, rng.normal(size=(L, L)), -10.0).astype(np.float32)
    var = np.where(occ, rng.uniform(1e-4, 0.2, (L, L)), -10.0).astype(
        np.float32)
    m = m.replace(elevation=torch.from_numpy(elev),
                  variance=torch.from_numpy(var),
                  start=torch.tensor([3, 17], dtype=torch.int32))
    valid = rng.random(P) < 0.9
    col = np.where(rng.random(P) < 0.5, rng.integers(1, 1 << 24, P), 0)
    batch = PointBatch(
        xy=torch.zeros((P, 2)),
        height=torch.from_numpy((rng.normal(size=P) * 2).astype(np.float32)),
        variance=torch.from_numpy(rng.uniform(1e-4, 0.3, P).astype(
            np.float32)),
        cell=torch.from_numpy(np.where(valid, rng.integers(0, L * L, P),
                                       L * L).astype(np.int32)),
        color=torch.from_numpy(col.astype(np.int32)),
        intensity=torch.from_numpy(np.where(col != 0, rng.random(P),
                                            0).astype(np.float32)),
        valid=torch.from_numpy(valid))
    move = lambda obj: type(obj)(**{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)})
    return cfg, move(m), move(batch)


def _k1_args(cfg, m, batch):
    L = cfg.map.length
    return (*fs.sort_points(batch, L * L), m.elevation.reshape(-1),
            m.variance.reshape(-1), cfg.map)


def _k3_args(n, S, device, clustered=True, seed=0, fs_=2, fm=2, fx=1):
    """Sorted ids (10% pad lanes == S) and (F, n) value columns."""
    rng = np.random.default_rng(seed)
    hi = min(S, max(n // 3, 1)) if clustered else S
    ids = np.where(rng.random(n) < 0.9, rng.integers(0, hi, n), S)
    ids = np.sort(ids).astype(np.int32)
    cols = [torch.from_numpy(rng.normal(size=(f, n)).astype(np.float32))
            for f in (fs_, fm, fx)]
    return [torch.from_numpy(ids).to(device)] + [c.to(device) for c in cols]


def test_cpu_tensors_run_the_plain_versions_uncounted():
    cfg, m, batch = _inputs(16, 256, "cpu")
    n1, n2 = fs.fuse_stream_aggregate.launches, ft.plane_fit_features.launches
    n3 = sst.segment_stats_sorted.launches
    args = _k1_args(cfg, m, batch)
    assert torch.equal(fs.fuse_stream_aggregate(*args),
                       fs.fuse_stream_aggregate_plain(*args))
    a = ft.plane_fit_features(m, cfg.map)
    b = ft.compute_features(m, cfg.map)
    assert torch.equal(a.slope, b.slope)
    k3 = _k3_args(512, 300, "cpu")
    got = sst.segment_stats_sorted(*k3, 300)
    for x, y in zip(got[:3], sst.segment_stats_sorted_plain(*k3, 300)):
        assert torch.equal(x, y)
    assert fs.fuse_stream_aggregate.launches == n1
    assert ft.plane_fit_features.launches == n2
    assert sst.segment_stats_sorted.launches == n3


def test_other_devices_are_refused():
    cfg, m, batch = _inputs(8, 64, "cpu")
    meta = lambda t: torch.empty_like(t, device="meta")
    args = [meta(t) for t in _k1_args(cfg, m, batch)[:-1]]
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fuse_stream_aggregate(*args, cfg.map)
    with pytest.raises(ValueError, match="unsupported device"):
        ft.plane_fit_features(m.replace(elevation=meta(m.elevation)),
                              cfg.map)
    with pytest.raises(ValueError, match="unsupported device"):
        sst.segment_stats_sorted(*[meta(t) for t in _k3_args(64, 32, "cpu")],
                                 32)


@pytest.mark.parametrize("L,P", [(64, 4096), (300, 1 << 17)])
def test_k1_matches_plain_on_card(cuda, L, P):
    cfg, m, batch = _inputs(L, P, cuda, seed=L)
    args = _k1_args(cfg, m, batch)
    before = fs.fuse_stream_aggregate.launches
    k = fs.fuse_stream_aggregate(*args)
    assert fs.fuse_stream_aggregate.launches == before + 1
    p = fs.fuse_stream_aggregate_plain(*args)
    torch.cuda.synchronize()
    exact = [r for r in range(16) if r not in (4, 5)]
    assert torch.equal(k[exact], p[exact])
    has = p[4] > 0
    assert torch.equal(k[4] > 0, has)
    rel = ((k[4:6] - p[4:6]).abs() / p[4].abs().clamp(min=1e-30))[:, has]
    assert float(rel.max()) <= 1e-5
    fused = fs.apply_aggregates(m, cfg, k)
    assert not bool(torch.isnan(fused.elevation).any())


def test_k1_rejects_wrong_dtype(cuda):
    cfg, m, batch = _inputs(16, 256, cuda)
    args = list(_k1_args(cfg, m, batch))
    args[1] = args[1].double()
    with pytest.raises(ValueError, match="expected contiguous"):
        fs.fuse_stream_aggregate(*args)


@pytest.mark.parametrize("L", [40, 257])
def test_k2_matches_plain_on_card(cuda, L):
    cfg, m, _ = _inputs(L, 64, cuda, seed=L)
    before = ft.plane_fit_features.launches
    k = ft.plane_fit_features(m, cfg.map)
    assert ft.plane_fit_features.launches == before + 1
    p = ft.compute_features(m, cfg.map)
    torch.cuda.synchronize()
    for key in ("neighbor_count", "slope", "rough", "traver", "normal_z"):
        assert torch.equal(getattr(k, key), getattr(p, key)), key


@pytest.mark.parametrize("L,start,valid", [
    (3, (1, 2), 0.9), (36, (0, 0), 1.0), (100, (99, 3), 1.0),
    (1000, (123, 457), 0.4)])
def test_k2_bitwise_on_card_at_edges_and_full_maps(cuda, L, start, valid):
    """Tiles that wrap, a window rolled to every edge, maps smaller than a
    tile, fully valid neighbourhoods (K2's precomputed sums) and sparse
    ones: all five planes equal the plain version's."""
    rng = np.random.default_rng(L)
    cfg = benchmark_config(length=L)
    g = np.arange(L) * cfg.map.resolution
    elev = (0.4 * np.sin(g[:, None] / 1.7) + 0.2 * g[None, :]
            + 0.02 * rng.standard_normal((L, L))).astype(np.float32)
    elev[rng.random((L, L)) >= valid] = cfg.map.invalid_elevation
    m = init_map_state(cfg.map, cuda).replace(
        elevation=torch.from_numpy(elev).to(cuda),
        start=torch.tensor(start, dtype=torch.int32, device=cuda))
    k = ft.plane_fit_features(m, cfg.map)
    p = ft.compute_features(m, cfg.map)
    torch.cuda.synchronize()
    for key in ("neighbor_count", "slope", "rough", "traver", "normal_z"):
        assert torch.equal(getattr(k, key), getattr(p, key)), key


def test_step_on_card_matches_cpu(cuda):
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline

    cfg = benchmark_config(length=64, max_points=4096)
    gpu = ElevationPipeline(cfg, device=cuda)
    cpu = ElevationPipeline(cfg, device="cpu")
    for f, _, _ in synthetic_frames(cfg, 5, n_points=4000, speed=0.4,
                                    seed=1, max_range=3.0, device="cpu"):
        cpu.process(f)
        gpu.process(type(f)(**{k: None if v is None else v.to(cuda)
                               for k, v in vars(f).items()}))
    a, b = gpu.state.map, cpu.state.map
    for key in ("elevation", "variance", "lowest"):
        torch.testing.assert_close(getattr(a, key).cpu(), getattr(b, key),
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(a.traver.cpu(), b.traver, rtol=0, atol=1e-3)
    assert torch.equal(a.color.cpu(), b.color)
    assert torch.equal(a.start.cpu(), b.start)


@pytest.mark.parametrize("n,S,clustered,fsz", [
    (4096, 4096, True, (2, 2, 1)), (4096, 4096, False, (1, 2, 1)),
    (1 << 17, 1000 * 1000, False, (2, 1, 1)), (1 << 17, 5000, True,
                                               (1, 1, 1))])
def test_k3_matches_plain_on_card(cuda, n, S, clustered, fsz):
    ids, sv, mv, xv = _k3_args(n, S, cuda, clustered, seed=n % 97, fs_=fsz[0],
                               fm=fsz[1], fx=fsz[2])
    before = sst.segment_stats_sorted.launches
    got = sst.segment_stats_sorted(ids, sv, mv, xv, S)
    # one launch per four columns
    assert sst.segment_stats_sorted.launches == before + (sum(fsz) + 3) // 4
    want = sst.segment_stats_sorted_plain(ids, sv, mv, xv, S)
    mag = sst.segment_stats_sorted_plain(ids, sv.abs(), mv, xv, S)[0]
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    # sums relative to the sum of their terms' magnitudes
    assert bool(((got[0] - want[0]).abs() <= 1e-5 * mag).all())
    assert int(got[3]) == int(sst.spill_count(ids, S))


@pytest.mark.parametrize("layout", ["one_segment", "long_runs",
                                    "gaps", "all_padding", "no_points",
                                    "three_points_one_cell",
                                    "four_points_first_two_share",
                                    "sparse_blocks"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_k3_adversarial_layouts_on_card(cuda, layout, dtype):
    """Layouts that stress K3's owners (a block owns 2048 segments and
    cuts its points into 8 warp parts by position): one segment holding
    every point, runs of 40-900 points straddling block edges, empty head
    and tail gaps, every lane padding, no point at all; blocks of 1 to 7
    points with repeated ids, which leave warp parts empty between two
    carries of one run; and (0, N) roles."""
    rng = np.random.default_rng(3)
    S = 10000
    if layout == "one_segment":
        ids = np.full(50000, 4321)
    elif layout == "long_runs":
        heads = [255, 256, 511, 2047, 2048, 4095, 9999]
        ids = np.concatenate([np.repeat(heads, rng.integers(40, 900, 7)),
                              np.full(33, S)])
    elif layout == "three_points_one_cell":
        ids = np.full(3, 4321)
    elif layout == "four_points_first_two_share":
        ids = np.array([4321, 4321, 4322, 4400, S, S])
    elif layout == "sparse_blocks":
        # blocks of 3 to 7 points, cell offsets within each block
        cells = [[0, 0, 0], [0, 0, 1, 2], [7] * 5, [0, 0, 1, 1, 2, 2],
                 [0, 3, 3, 3, 3, 9, 9]]
        ids = np.concatenate([2048 * k + 1000 + np.array(c) for k, c in
                              enumerate(cells)] + [np.full(9, S)])
    elif layout == "gaps":
        ids = np.concatenate([rng.integers(3000, 6000, 5000), np.full(5, S)])
    elif layout == "all_padding":
        ids = np.full(777, S)
    else:
        ids = np.zeros(0, np.int64)
    ids = torch.from_numpy(np.sort(ids)).to(cuda, dtype)
    n = ids.shape[0]
    cols = [torch.from_numpy(rng.normal(size=(f, n)).astype(np.float32))
            .to(cuda) for f in (2, 0, 1)]
    got = sst.segment_stats_sorted(ids, *cols, S, with_spill=False)
    want = sst.segment_stats_sorted_plain(ids, *cols, S)
    mag = sst.segment_stats_sorted_plain(ids, cols[0].abs(), *cols[1:], S)[0]
    torch.cuda.synchronize()
    assert tuple(got[1].shape) == (0, S)
    assert torch.equal(got[2], want[2])
    assert bool(((got[0] - want[0]).abs() <= 1e-5 * mag).all())


def test_k3_rejects_bad_shapes(cuda):
    ids, sv, mv, xv = _k3_args(256, 64, cuda)
    with pytest.raises(ValueError, match="must be"):
        sst.segment_stats_sorted(ids, sv[:, :100], mv, xv, 64)
    with pytest.raises(ValueError, match="expected contiguous"):
        sst.segment_stats_sorted(ids, sv.double(), mv, xv, 64)


@pytest.mark.parametrize("backend", ["pallas", "segment", "sort"])
def test_fuse_backends_on_card_match_cpu(cuda, backend):
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline

    cfg = benchmark_config(length=64, max_points=4096)
    gpu = ElevationPipeline(cfg, device=cuda, fuse_backend=backend)
    cpu = ElevationPipeline(cfg, device="cpu", fuse_backend=backend)
    before = sst.segment_stats_sorted.launches
    for f, _, _ in synthetic_frames(cfg, 5, n_points=4000, speed=0.4,
                                    seed=2, max_range=3.0, device="cpu"):
        cpu.process(f)
        gpu.process(type(f)(**{k: None if v is None else v.to(cuda)
                               for k, v in vars(f).items()}))
    launches = sst.segment_stats_sorted.launches - before
    assert launches == (25 if backend == "pallas" else 0)
    a, b = gpu.state.map, cpu.state.map
    for key in ("elevation", "variance"):
        torch.testing.assert_close(getattr(a, key).cpu(), getattr(b, key),
                                   rtol=0, atol=1e-4)
    assert torch.equal(a.lowest.cpu(), b.lowest)
    torch.testing.assert_close(a.traver.cpu(), b.traver, rtol=0, atol=1e-3)
    assert torch.equal(a.color.cpu(), b.color)


def test_fleet_step_on_card_equals_single_pipelines(cuda):
    """Four robots with uneven streams through `fleet_step` (stream path:
    K1 and K2 once per robot and frame) against four ElevationPipelines on
    the card: every leaf bitwise."""
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline
    from gem_tpu_torch.multirobot.fleet import (fleet_effective_config,
                                                fleet_step, make_fleet_state,
                                                stack_frames)
    from gem_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = benchmark_config(length=64, max_points=4096)
    cfg = cfg.replace(submap=dataclasses.replace(
        cfg.submap, keyframe_distance=1.0, max_submaps=3, capacity=2048))
    n, T = 4, 6
    streams = [[f for f, _, _ in synthetic_frames(
        cfg, T, n_points=1000 + 700 * r, speed=0.3 + 0.15 * r, seed=r,
        max_range=3.0, device=cuda)] for r in range(n)]
    fleet = make_fleet_state(cfg, n, device=cuda)
    pipes = [ElevationPipeline(fleet_effective_config(cfg), device=cuda)
             for _ in range(n)]
    k1, k2 = fs.fuse_stream_aggregate.launches, ft.plane_fit_features.launches
    for t in range(T):
        fleet, _ = fleet_step(fleet, stack_frames(
            [streams[r][t] for r in range(n)]), cfg)
    assert fs.fuse_stream_aggregate.launches - k1 == n * T
    assert ft.plane_fit_features.launches - k2 == n * T
    for r in range(n):
        for f in streams[r]:
            pipes[r].process(f)
        a = tree_leaves(pipes[r].state)
        b = tree_leaves(tree_map(lambda x: x[r], fleet))
        for key in a:
            assert torch.equal(a[key], b[key]), (r, key)
    assert int(fleet.submaps.num_submaps.max()) >= 1


def test_world_one_nccl_matches_gloo_on_cpu(cuda, tmp_path):
    """An NCCL process group of one on the card: `ring_shift` is a local
    copy, and the sharded loop closure of a 8-slot store on the card equals
    the same call over a gloo group on the CPU (x/y bitwise, z and variance
    within 1e-5, the stats equal)."""
    import torch.distributed as dist

    from gem_tpu_torch.global_map import submaps as sm
    from gem_tpu_torch.global_map.sharded import (apply_sharded_loop_closure,
                                                  shard_store)
    from gem_tpu_torch.multirobot import distributed as mdist

    cfg = benchmark_config(length=64, max_points=4096)
    cfg = cfg.replace(submap=dataclasses.replace(cfg.submap, max_submaps=8,
                                                 capacity=1024))
    rng = np.random.default_rng(0)
    res = cfg.map.resolution
    mdist.initialize(str(tmp_path / "store"), 1, 0, backend="nccl")
    try:
        gloo = dist.new_group([0], backend="gloo")
        x = torch.arange(6, device=cuda, dtype=torch.float32)
        assert torch.equal(mdist.ring_shift(x), x)
        stores, poses = {}, np.zeros((8, 7), np.float32)
        poses[:, 3] = 1.0
        poses[:, 0] = np.arange(8) * 0.5
        for dev in ("cpu", cuda):
            store = sm.init_store(cfg, dev)
            gen = np.random.default_rng(1)
            for k in range(8):
                C = 1024
                f = {"x": (gen.integers(-30, 30, C) + 0.5) * res + k * 0.5,
                     "y": (gen.integers(-30, 30, C) + 0.5) * res,
                     "z": gen.normal(0, 0.2, C),
                     "variance": gen.uniform(0.01, 0.99, C),
                     "intensity": gen.random(C), "traver": gen.random(C)}
                f = {k_: torch.from_numpy(v.astype(np.float32)).to(dev)
                     for k_, v in f.items()}
                buf = sm.PointBuffer(
                    **f, color=torch.zeros(C, dtype=torch.int32, device=dev),
                    valid=torch.ones(C, dtype=torch.bool, device=dev))
                store = sm.finalize_submap(store, buf,
                                           torch.from_numpy(poses[k]).to(dev))
            stores[str(dev)] = store
        opt = poses.copy()
        opt[1:, :2] += res * rng.integers(-2, 3, (7, 2))
        got, st = apply_sharded_loop_closure(
            shard_store(stores[str(cuda)]), cfg, opt)
        ref, st_ref = apply_sharded_loop_closure(
            shard_store(stores["cpu"], gloo), cfg, opt, gloo)
        assert st == st_ref and st["n_cells_fused"] > 0
        for key in ("x", "y"):
            assert torch.equal(getattr(got.slots, key).cpu(),
                               getattr(ref.slots, key)), key
        for key in ("z", "variance"):
            torch.testing.assert_close(getattr(got.slots, key).cpu(),
                                       getattr(ref.slots, key), rtol=0,
                                       atol=1e-5)
    finally:
        mdist.shutdown()


def _ring_store(cfg, device):
    """A full ring of cell-center patches around a 12 m loop (every pair
    overlaps), variances in (0, 1), and the poses of its slots."""
    from gem_tpu_torch.global_map import submaps as sm

    K, C = cfg.submap.max_submaps, cfg.submap.capacity
    res = cfg.map.resolution
    rng = np.random.default_rng(0)
    store = sm.init_store(cfg, device)
    poses = np.zeros((K, 7), np.float32)
    poses[:, 3] = 1.0
    for k in range(K):
        a = 2 * np.pi * k / K
        poses[k, :2] = 2.0 * np.cos(a), 2.0 * np.sin(a)
        f = {"x": (np.round(poses[k, 0] / res) + rng.integers(-30, 30, C)
                   + 0.5) * res,
             "y": (np.round(poses[k, 1] / res) + rng.integers(-30, 30, C)
                   + 0.5) * res,
             "z": rng.normal(0, 0.2, C), "variance": rng.uniform(0.01, 0.99, C),
             "intensity": rng.random(C), "traver": rng.random(C)}
        buf = sm.PointBuffer(
            **{key: torch.from_numpy(v.astype(np.float32)).to(device)
               for key, v in f.items()},
            color=torch.zeros(C, dtype=torch.int32, device=device),
            valid=torch.from_numpy(rng.random(C) < 0.95).to(device))
        store = sm.finalize_submap(store, buf,
                                   torch.from_numpy(poses[k]).to(device))
    return store, poses


def _multi_rank_worker(rank, world, store_path, out_dir, backend, L, K, C):
    """One rank of `world` (NCCL: one card each; gloo: the CPU): the sharded
    loop closure over every rank against the same call over a group of one
    on rank 0 (x/y bitwise, z/variance within 1e-5, stats equal); a mixed
    payload around the ring in both directions; the halo stencil over every
    rank against the unsharded plane fit (K2 on a card) within 1e-5.
    Writes `rank<r>.ok` when every check passed."""
    import torch.distributed as dist

    from gem_tpu_torch.core.state import init_map_state
    from gem_tpu_torch.global_map.sharded import (apply_sharded_loop_closure,
                                                  shard_store)
    from gem_tpu_torch.multirobot import distributed as mdist
    from gem_tpu_torch.multirobot.spatial import (place_row_sharded,
                                                  sharded_features)

    mdist.initialize(store_path, world, rank, backend=backend, timeout_s=300)
    try:
        dev = mdist.device()
        one = dist.new_group([0])
        cfg = benchmark_config(length=L)
        cfg = cfg.replace(submap=dataclasses.replace(
            cfg.submap, max_submaps=K, capacity=C))
        store, poses = _ring_store(cfg, dev)
        opt = poses.copy()
        opt[1:, :2] += cfg.map.resolution * np.random.default_rng(1).integers(
            -2, 3, (K - 1, 2))
        got, st = apply_sharded_loop_closure(shard_store(store), cfg, opt)
        parts = {}
        for key in ("x", "y", "z", "variance"):
            mine = getattr(got.slots, key).contiguous()
            parts[key] = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts[key], mine)
        if rank == 0:
            ref, st1 = apply_sharded_loop_closure(shard_store(store, one),
                                                  cfg, opt, one)
            assert st == st1 and st["n_cells_fused"] > 0, (st, st1)
            for key, tol in (("x", 0), ("y", 0), ("z", 1e-5),
                             ("variance", 1e-5)):
                d = (torch.cat(parts[key]) - getattr(ref.slots, key)).abs()
                assert float(d.max()) <= tol, (key, float(d.max()))
        payload = [torch.full((5,), float(rank), device=dev),
                   torch.tensor([rank % 2 == 0], device=dev),
                   torch.full((3,), rank, dtype=torch.int64, device=dev)]
        for d in (1, -1):
            src = (rank - d) % world
            a, b, c = mdist.ring_shift_tensors(payload, direction=d)
            assert float(a[0]) == src and bool(b[0]) == (src % 2 == 0) \
                and int(c[2]) == src, (d, a, b, c)
        rng = np.random.default_rng(12)
        g = np.arange(L) * cfg.map.resolution
        elev = (0.5 * np.sin(g[:, None] / 7.0) + 0.4 * np.cos(g[None, :] / 9.0)
                + 0.01 * rng.standard_normal((L, L))).astype(np.float32)
        elev[rng.random((L, L)) < 0.2] = -10.0
        m = init_map_state(cfg.map, dev).replace(
            elevation=torch.from_numpy(elev).to(dev))
        want = ft.plane_fit_features(m, cfg.map)
        sh = sharded_features(cfg.map)(place_row_sharded(m.elevation))
        rows = L // world
        for key, v in zip(("slope", "rough", "traver"), sh):
            w = getattr(want, key)[rank * rows:(rank + 1) * rows]
            assert float((v - w).abs().max()) <= 1e-5, key
        mdist.barrier("checked")
        open(os.path.join(out_dir, f"rank{rank}.ok"), "w").close()
    finally:
        mdist.shutdown()


def _run_ranks(world, tmp_path, backend, **sizes):
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _multi_rank_worker,
        args=(world, str(tmp_path / "store"), str(tmp_path), backend,
              sizes["L"], sizes["K"], sizes["C"]),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 420
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "ranks still running"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert all((tmp_path / f"rank{r}.ok").exists() for r in range(world))


def test_four_gloo_ranks_on_the_cpu(tmp_path):
    """The four-card check's own code, on 4 gloo processes on the CPU at a
    small size: it runs wherever the suite runs."""
    _run_ranks(4, tmp_path, "gloo", L=64, K=8, C=512)


def test_four_cards_nccl_ring(cuda, tmp_path):
    """One process per card over NCCL at the flagship's ring (64 slots) and
    map (L=1000); then `fleet --mesh` spawns one process per card and its
    robots fuse what the one-process fleet fuses on one card."""
    import subprocess
    import sys

    from gem_tpu_torch.kernels import _build

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    _build.build()                  # once, before the ranks load it
    _run_ranks(4, tmp_path, "nccl", L=1000, K=64, C=32768)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "gem_tpu_torch", "fleet", "--robots", "4",
           "--frames", "3", "--max-points", "16384"]
    fused = []
    for extra in (["--mesh"], []):
        out = subprocess.run(cmd + extra, cwd=repo, capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert ("mesh)" if extra else "vmap)") in out.stdout
        fused.append(out.stdout.split("per-robot fused cells: ")[1]
                     .splitlines()[0])
    assert fused[0] == fused[1]
