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


def _k1_layout(layout, L, rng):
    """(cell ids, valid) of a sorted-point layout that stresses K1's owners
    (a block owns 256 consecutive cells and cuts their points into 8 warp
    parts by position)."""
    S = L * L
    if layout == "one_cell":
        cells = np.full(20000, S // 2 + 3)
    elif layout == "tile_edge_runs":
        heads = [255, 256, 511, 512, 767, 1024, S - 257, S - 256, S - 1]
        cells = np.repeat(heads, rng.integers(1, 900, len(heads)))
    elif layout == "runs_of_1_to_7":
        heads = np.sort(rng.choice(S, S // 3, replace=False))
        cells = np.repeat(heads, rng.integers(1, 8, len(heads)))
    elif layout == "empty_head_and_tail_tiles":
        cells = rng.integers(S // 3, 2 * S // 3, 5000)
    elif layout == "all_padding":
        return rng.integers(0, S, 777), np.zeros(777, bool)
    else:                                   # no point at all
        cells = np.zeros(0, np.int64)
    return cells, np.ones(len(cells), bool)


@pytest.mark.parametrize("layout", ["one_cell", "tile_edge_runs",
                                    "runs_of_1_to_7",
                                    "empty_head_and_tail_tiles",
                                    "all_padding", "no_points"])
@pytest.mark.parametrize("with_color", [True, False])
def test_k1_adversarial_layouts_on_card(cuda, layout, with_color):
    """K1 against its plain version on layouts that stress its owners: one
    cell holding every point, runs of 1-900 points on cells that straddle
    the 256-cell tile edges (the map's last cell included), runs of 1-7
    points, points only in the middle third (empty head and tail tiles),
    every lane padding and no point at all; over a prior with half its
    cells fused.  Heights lie on a 1/16 m grid in [-1, 1] m with 10%
    lifted 2.5 m (outlier start rows) and variances are 1/16, 1/32 or 1/64
    (exact v ties), so every weight w and w*h is an integer and the gated
    sums are exact in any order: every row must equal the plain version's,
    and a second launch must be bitwise the first."""
    rng = np.random.default_rng(17)
    L = 64
    cfg = benchmark_config(length=L)
    cells, valid = _k1_layout(layout, L, rng)
    P = len(cells)
    col = np.where(rng.random(P) < 0.5, rng.integers(1, 1 << 24, P), 0)
    h = (np.clip(np.round(rng.normal(size=P) * 0.3 * 16) / 16, -1, 1)
         + (rng.random(P) < 0.1) * 2.5)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(cuda)
    batch = PointBatch(
        xy=torch.zeros((P, 2), device=cuda), height=t(h, np.float32),
        variance=t(2.0 ** -rng.integers(4, 7, P), np.float32),
        cell=t(cells, np.int32), color=t(col, np.int32),
        intensity=t(np.where(col != 0, rng.integers(1, 4, P), 0),
                    np.float32),
        valid=t(valid, bool))
    occ = rng.random(L * L) < 0.5
    elev0 = t(np.where(occ, rng.normal(size=L * L) * 0.3, -10.0), np.float32)
    var0 = t(np.where(occ, rng.uniform(1e-4, 0.05, L * L), -10.0),
             np.float32)
    args = (*fs.sort_points(batch, L * L, with_color), elev0, var0, cfg.map)
    k = fs.fuse_stream_aggregate(*args, with_color=with_color)
    again = fs.fuse_stream_aggregate(*args, with_color=with_color)
    p = fs.fuse_stream_aggregate_plain(*args, with_color=with_color)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    assert torch.equal(k, p)
    assert bool((p[2] > 0).any()) == (layout not in ("all_padding",
                                                     "no_points"))


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


# --- the robot grid axis ------------------------------------------------------


def _robot_batch(L, counts, device, seed=0, exact=False):
    """An (R, P) point batch whose robot r has counts[r] valid points
    (the rest padding), with P = max(counts) + 5; `exact`: heights on a
    1/16 m grid and power-of-two variances, so K1's sums are exact."""
    rng = np.random.default_rng(seed)
    R, P = len(counts), max(counts) + 5
    valid = np.arange(P)[None, :] < np.asarray(counts)[:, None]
    cells = rng.integers(0, L * L, (R, P))
    if exact:
        h = np.clip(np.round(rng.normal(size=(R, P)) * 5) / 16, -1, 1) \
            + (rng.random((R, P)) < 0.1) * 2.5
        v = 2.0 ** -rng.integers(4, 7, (R, P))
    else:
        h = rng.normal(size=(R, P)) * 2
        v = rng.uniform(1e-4, 0.3, (R, P))
    col = np.where(rng.random((R, P)) < 0.5,
                   rng.integers(1, 1 << 24, (R, P)), 0)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)
    return PointBatch(
        xy=torch.zeros((R, P, 2), device=device), height=t(h, np.float32),
        variance=t(v, np.float32),
        cell=t(np.where(valid, cells, L * L), np.int32),
        color=t(col, np.int32),
        intensity=t(np.where(col != 0, rng.integers(1, 4, (R, P)), 0),
                    np.float32),
        valid=t(valid, bool))


def _priors(L, R, device, seed=0):
    rng = np.random.default_rng(seed)
    occ = rng.random((R, L * L)) < 0.5
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return (t(np.where(occ, rng.normal(size=(R, L * L)) * 0.3, -10.0)),
            t(np.where(occ, rng.uniform(1e-4, 0.05, (R, L * L)), -10.0)))


def _robot(batch, r):
    return PointBatch(**{f.name: getattr(batch, f.name)[r]
                         for f in dataclasses.fields(batch)})


def _k1_robots_check(cfg, batch, elev0, var0, exact):
    """K1 over the robot axis against its plain version and against each
    robot's own single launch (bitwise); one launch for the fleet."""
    L = cfg.map.length
    srt = fs.sort_points(batch, L * L)
    before = fs.fuse_stream_aggregate.launches
    k = fs.fuse_stream_aggregate(*srt, elev0, var0, cfg.map)
    assert fs.fuse_stream_aggregate.launches == before + 1
    p = fs.fuse_stream_aggregate_plain(*srt, elev0, var0, cfg.map)
    torch.cuda.synchronize()
    R = elev0.shape[0]
    assert tuple(k.shape) == (R, 16, L * L)
    if exact:
        assert torch.equal(k, p)
    else:
        exact_rows = [r for r in range(16) if r not in (4, 5)]
        assert torch.equal(k[:, exact_rows], p[:, exact_rows])
        has = p[:, 4] > 0
        rel = (k[:, 4:6] - p[:, 4:6]).abs() \
            / p[:, 4:5].abs().clamp(min=1e-30)
        assert float(rel.amax(1)[has].max()) <= 1e-5
    for r in range(R):
        one = fs.fuse_stream_aggregate(
            *fs.sort_points(_robot(batch, r), L * L), elev0[r], var0[r],
            cfg.map)
        assert torch.equal(k[r].view(torch.int32), one.view(torch.int32)), r
    return k


def test_k1_robot_axis_on_card(cuda):
    """Three robots with uneven valid counts at L = 50 (2500 cells, not a
    multiple of K1's 256-cell tile): against the plain version (selection
    rows bitwise, W and WH within 1e-5) and robot by robot against single
    launches, bitwise; R = 1 is bitwise the launch without a robot axis."""
    L = 50
    cfg = benchmark_config(length=L)
    batch = _robot_batch(L, [3001, 17, 2203], cuda, seed=5)
    elev0, var0 = _priors(L, 3, cuda, seed=6)
    _k1_robots_check(cfg, batch, elev0, var0, exact=False)
    one = _robot(batch, 0)
    lead = PointBatch(**{f.name: getattr(one, f.name)[None]
                         for f in dataclasses.fields(one)})
    a = fs.fuse_stream_aggregate(*fs.sort_points(lead, L * L), elev0[:1],
                                 var0[:1], cfg.map)
    b = fs.fuse_stream_aggregate(*fs.sort_points(one, L * L), elev0[0],
                                 var0[0], cfg.map)
    assert torch.equal(a[0].view(torch.int32), b.view(torch.int32))


def test_k1_robot_axis_runs_on_robot_edges_on_card(cuda):
    """Robot 0's last tile and robot 1's first tile both hold runs longer
    than K1's short-run limit (16 points), at L = 50, on exact-sum data:
    every row equals the plain version's and each robot's single launch."""
    L = 50
    S = L * L
    cfg = benchmark_config(length=L)
    batch = _robot_batch(L, [4000, 4000, 900], cuda, seed=9, exact=True)
    cells = batch.cell.cpu().numpy()
    tail = np.repeat([S - 1, S - 2, S - 40, S - 196, 2304],
                     [700, 300, 17, 90, 400])
    head = np.repeat([0, 1, 255, 256], [800, 19, 600, 33])
    cells[0, :len(tail)] = tail
    cells[1, :len(head)] = head
    batch = dataclasses.replace(batch, cell=torch.from_numpy(
        np.where(batch.valid.cpu().numpy(), cells, S).astype(np.int32)
    ).to(cuda))
    elev0, var0 = _priors(L, 3, cuda, seed=10)
    _k1_robots_check(cfg, batch, elev0, var0, exact=True)


def test_k2_robot_axis_on_card(cuda):
    """K2 over three robots' planes with their own starts at L = 257 (not
    a multiple of the 32 x 8 tile): all five planes bitwise the plain
    version's and each robot's single launch; one launch for the fleet."""
    L, R = 257, 3
    rng = np.random.default_rng(4)
    cfg = benchmark_config(length=L)
    g = np.arange(L) * cfg.map.resolution
    elev = (0.4 * np.sin(g[:, None] / 1.7) + 0.2 * g[None, :]
            + 0.02 * rng.standard_normal((R, L, L))).astype(np.float32)
    elev[rng.random((R, L, L)) >= np.array([1.0, 0.6, 0.2])[:, None, None]] \
        = cfg.map.invalid_elevation
    starts = torch.tensor([[0, 0], [256, 3], [100, 200]], dtype=torch.int32)
    m = init_map_state(cfg.map, cuda)
    ms = type(m)(**{f.name: getattr(m, f.name).unsqueeze(0).repeat(
        (R,) + (1,) * getattr(m, f.name).dim())
        for f in dataclasses.fields(m)})
    ms = ms.replace(elevation=torch.from_numpy(elev).to(cuda),
                    start=starts.to(cuda))
    before = ft.plane_fit_features.launches
    k = ft.plane_fit_features(ms, cfg.map)
    assert ft.plane_fit_features.launches == before + 1
    p = ft.compute_features(ms, cfg.map)
    torch.cuda.synchronize()
    for key in ("neighbor_count", "slope", "rough", "traver", "normal_z"):
        assert torch.equal(getattr(k, key), getattr(p, key)), key
    for r in range(R):
        one = ft.plane_fit_features(
            m.replace(elevation=ms.elevation[r].contiguous(),
                      start=ms.start[r].contiguous()), cfg.map)
        for key in ("neighbor_count", "slope", "rough", "traver",
                    "normal_z"):
            assert torch.equal(getattr(k, key)[r], getattr(one, key)), key


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_k3_robot_axis_on_card(cuda, dtype):
    """K3 over three robots' sorted ids (S = 5000, not a multiple of the
    2048-segment block), uneven valid counts, and runs of 40-900 points at
    the end of robot 0's segments and the start of robot 1's: mins and
    maxs bitwise the plain version's, sums within 1e-5 of their terms'
    magnitudes, and each robot bitwise its single launch; one launch per
    four columns for the fleet."""
    rng = np.random.default_rng(12)
    S, n, R = 5000, 6144, 3
    ids = np.full((R, n), S)
    ids[0, :3000] = np.repeat([S - 1, S - 2, 4095, 4096, 2047],
                              [900, 41, 500, 800, 759])
    ids[1, :2500] = np.repeat([0, 1, 2047, 2048], [850, 40, 700, 910])
    ids[2, :1234] = rng.integers(0, S, 1234)
    ids = np.sort(ids, axis=1)
    t_ids = torch.from_numpy(ids).to(cuda, dtype)
    cols = [torch.from_numpy(rng.normal(size=(f, R, n)).astype(np.float32))
            .to(cuda) for f in (2, 2, 1)]
    before = sst.segment_stats_sorted.launches
    got = sst.segment_stats_sorted(t_ids, *cols, S, with_spill=False)
    assert sst.segment_stats_sorted.launches == before + 2
    want = sst.segment_stats_sorted_plain(t_ids, *cols, S)
    mag = sst.segment_stats_sorted_plain(t_ids, cols[0].abs(), *cols[1:],
                                         S)[0]
    torch.cuda.synchronize()
    assert tuple(got[0].shape) == (2, R, S)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert bool(((got[0] - want[0]).abs() <= 1e-5 * mag).all())
    for r in range(R):
        one = sst.segment_stats_sorted(
            t_ids[r].contiguous(), *[c[:, r].contiguous() for c in cols], S,
            with_spill=False)
        for a, b in zip(got[:3], one[:3]):
            assert torch.equal(a[:, r].view(torch.int32),
                               b.view(torch.int32)), r


def test_fleet_pallas_on_card_equals_single_pipelines(cuda):
    """The pallas fleet (5 x K3 and K2 per fleet frame) against single
    ElevationPipelines on the card: every leaf bitwise."""
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline
    from gem_tpu_torch.multirobot.fleet import (fleet_effective_config,
                                                fleet_step, make_fleet_state,
                                                stack_frames)
    from gem_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = benchmark_config(length=64, max_points=4096)
    n, T = 3, 4
    streams = [[f for f, _, _ in synthetic_frames(
        cfg, T, n_points=900 + 1100 * r, speed=0.3 + 0.2 * r, seed=r,
        max_range=3.0, device=cuda)] for r in range(n)]
    fleet = make_fleet_state(cfg, n, device=cuda)
    k3 = sst.segment_stats_sorted.launches
    for t in range(T):
        fleet, _ = fleet_step(fleet, stack_frames(
            [streams[r][t] for r in range(n)]), cfg, fuse_backend="pallas")
    assert sst.segment_stats_sorted.launches - k3 == 5 * T
    for r in range(n):
        pipe = ElevationPipeline(fleet_effective_config(cfg), device=cuda,
                                 fuse_backend="pallas")
        for f in streams[r]:
            pipe.process(f)
        a = tree_leaves(pipe.state)
        b = tree_leaves(tree_map(lambda x: x[r], fleet))
        for key in a:
            assert torch.equal(a[key], b[key]), (r, key)


@pytest.mark.parametrize("backend", ["pallas", "segment", "sort"])
def test_fuse_backends_on_card_match_cpu(cuda, backend):
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline

    from torch.profiler import ProfilerActivity, profile

    cfg = benchmark_config(length=64, max_points=4096)
    gpu = ElevationPipeline(cfg, device=cuda, fuse_backend=backend)
    cpu = ElevationPipeline(cfg, device="cpu", fuse_backend=backend)
    before = sst.segment_stats_sorted.launches
    frames = [f for f, _, _ in synthetic_frames(
        cfg, 5, n_points=4000, speed=0.4, seed=2, max_range=3.0,
        device="cpu")]
    on_card = [type(f)(**{k: None if v is None else v.to(cuda)
                          for k, v in vars(f).items()}) for f in frames]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f, g in zip(frames, on_card):
            cpu.process(f)
            gpu.process(g)
        torch.cuda.synchronize()
    # K3 runs 5 times a frame on the device; the pipeline's graph calls
    # the wrapper only on its eager first frame and in the capture
    launches = sum("segment_stats_kernel" in e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert launches == (25 if backend == "pallas" else 0)
    assert sst.segment_stats_sorted.launches - before \
        == (10 if backend == "pallas" else 0)
    a, b = gpu.state.map, cpu.state.map
    for key in ("elevation", "variance"):
        torch.testing.assert_close(getattr(a, key).cpu(), getattr(b, key),
                                   rtol=0, atol=1e-4)
    assert torch.equal(a.lowest.cpu(), b.lowest)
    torch.testing.assert_close(a.traver.cpu(), b.traver, rtol=0, atol=1e-3)
    assert torch.equal(a.color.cpu(), b.color)


def test_fleet_step_on_card_equals_single_pipelines(cuda):
    """Four robots with uneven streams through `fleet_step` (stream path:
    K1 and K2 once per fleet frame, the robots a grid axis) against four
    ElevationPipelines on the card: every leaf bitwise."""
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
    assert fs.fuse_stream_aggregate.launches - k1 == T
    assert ft.plane_fit_features.launches - k2 == T
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


# --- the step as a CUDA graph (utils/graph.py) ----------------------------


def _graph_cfg(L=64):
    cfg = benchmark_config(length=L, max_points=4096)
    return cfg.replace(submap=dataclasses.replace(
        cfg.submap, keyframe_distance=1.0, staging_frames=3, capacity=2048,
        max_submaps=3))


def _graph_frames(cfg, device, n=8, seed=1):
    """n frames at 0.35 m per frame (a keyframe every third); frame 3
    closes a loop (pose +0.5 m, z +0.3 m) and the jump then settles and
    finishes, as tests/test_torch_pipeline.py drives the JAX parity."""
    from gem_tpu_torch.io.replay import synthetic_frames

    fr = [f for f, _, _ in synthetic_frames(cfg, n, n_points=3000,
                                            speed=0.35, seed=seed,
                                            max_range=3.0, device=device)]
    shift = torch.tensor([0.5, 0.0, 0.3], device=device)
    for i in range(3, n):
        bump = torch.tensor([0.0, 0.0, 0.05 if i >= 7 else 0.0],
                            device=device)
        fr[i] = dataclasses.replace(fr[i],
                                    track_position=fr[i].track_position
                                    + shift + bump)
    fr[3] = dataclasses.replace(fr[3], loop_closure=torch.ones(
        (), dtype=torch.bool, device=device))
    return fr


def _without_loop_flag(frames, n):
    """The first n frames without a `loop_closure` leaf: another input
    structure than the frames that carry one."""
    return [dataclasses.replace(f, loop_closure=None) if i < n else f
            for i, f in enumerate(frames)]


def _leaves_equal(a, b):
    from gem_tpu_torch.utils.tree import tree_leaves

    a, b = tree_leaves(a), tree_leaves(b)
    assert a.keys() == b.keys()
    return [k for k in a if a[k].dtype != b[k].dtype
            or not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("backend", ["stream", "pallas"])
def test_graph_capture_equals_eager_bitwise(cuda, backend):
    """ElevationPipeline replays CUDA graphs of `step`, one per input
    structure: frames 0-2 carry no `loop_closure` leaf, frame 3 (the loop
    closure) and the rest do, so frames 0 and 3 capture.  After every
    frame each state leaf and each output equals the eager `step` loop
    bitwise, and the replays launch through the graph, not the
    wrappers."""
    from gem_tpu_torch.mapping.pipeline import (ElevationPipeline,
                                                init_pipeline_state, step)

    cfg = _graph_cfg()
    frames = _without_loop_flag(_graph_frames(cfg, cuda), 3)
    pipe = ElevationPipeline(cfg, device=cuda, fuse_backend=backend)
    state = init_pipeline_state(cfg, cuda)
    wrapper = (ft.plane_fit_features if backend == "pallas"
               else fs.fuse_stream_aggregate)
    saw_jump = saw_keyframe = 0
    for i, f in enumerate(frames):
        calls = wrapper.launches
        out = pipe.process(f)
        # frames 0 and 3 (a new structure) run eagerly and capture: two
        # wrapper calls; every other frame is a replay, which calls none
        assert wrapper.launches - calls == (2 if i in (0, 3) else 0), i
        state, ref = step(state, f, cfg, fuse_backend=backend)
        assert not _leaves_equal(pipe.state, state), (i, _leaves_equal(
            pipe.state, state))
        assert not _leaves_equal(out, ref), (i, _leaves_equal(out, ref))
        saw_jump += bool(state.jump_odom)
        saw_keyframe += bool(ref.keyframe_due)
    assert saw_jump and saw_keyframe and int(state.submaps.num_submaps) >= 2


def test_graph_scan_and_fleet_equal_eager_bitwise(cuda):
    """`ElevationPipeline.scan_steps` (one graph of T steps) against T eager
    steps, and `FleetPipeline` (one graph per fleet frame) against eager
    `fleet_step`: every leaf bitwise."""
    from gem_tpu_torch.mapping.pipeline import (ElevationPipeline,
                                                init_pipeline_state, step)
    from gem_tpu_torch.multirobot.fleet import (FleetPipeline, fleet_step,
                                                make_fleet_state,
                                                stack_frames)

    cfg = _graph_cfg()
    frames = _graph_frames(cfg, cuda)[:3]
    pipe = ElevationPipeline(cfg, device=cuda)
    m = pipe.scan_steps(frames)
    state = init_pipeline_state(cfg, cuda)
    for f in frames:
        state, out = step(state, f, cfg)
    assert not _leaves_equal(pipe.state, state)
    assert int(m["cells_fused"][-1]) == int(out.metrics["cells_fused"]) > 0
    streams = [_graph_frames(cfg, cuda, n=5, seed=10 + r) for r in range(3)]
    fleet = FleetPipeline(cfg, 3, device=cuda)
    ref = make_fleet_state(cfg, 3, device=cuda)
    for t in range(4):       # frames 0-3: the loop closes in frame 3
        frames = stack_frames([s[t] for s in streams])
        outs = fleet.process(frames)
        ref, ref_outs = fleet_step(ref, frames, cfg)
        assert not _leaves_equal(fleet.state, ref), t
        assert not _leaves_equal(outs, ref_outs), t


def test_graph_outputs_kept_across_process_keep_their_values(cuda):
    """An output kept across the next `process` keeps its values: the
    pipeline copies its outputs out of the graph's tensors."""
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline
    from gem_tpu_torch.utils.tree import tree_map

    cfg = _graph_cfg()
    frames = _graph_frames(cfg, cuda)
    pipe = ElevationPipeline(cfg, device=cuda)
    first = pipe.process(frames[0])
    kept = tree_map(torch.clone, first)
    second = pipe.process(frames[1])
    pipe.process(frames[2])
    assert not _leaves_equal(first, kept)
    assert not torch.equal(first.features.traver, second.features.traver)


def test_process_is_free_of_syncs(cuda):
    """`process`, `scan_steps` and the fleet's `process` under
    `torch.cuda.set_sync_debug_mode("error")`, first calls included (the
    warm-up that builds the cached device tables, and the capture): no
    host read and no blocking upload.  L=72, which no other test uses, so
    the raytrace tables are built under the probe."""
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline
    from gem_tpu_torch.multirobot.fleet import FleetPipeline, stack_frames

    cfg = _graph_cfg(L=72)
    frames = _graph_frames(cfg, cuda)
    fleet_frames = [stack_frames([f, f]) for f in frames[:2]]
    pipes = [ElevationPipeline(cfg, device=cuda, fuse_backend=b)
             for b in ("stream", "pallas")]
    fleet = FleetPipeline(cfg, 2, device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pipe in pipes:
            for f in frames:
                pipe.process(f)
            pipe.scan_steps(frames[:3])
        for f in fleet_frames:
            fleet.process(f)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    assert int(pipes[0].state.frame_idx) == len(frames) + 3


def test_failed_capture_raises(cuda):
    """A function that reads the device to the host cannot be captured:
    the call raises (after its eager first run, which advanced the state),
    keeps no graph, and so the next call raises again; nothing falls back
    to running eagerly."""
    from gem_tpu_torch.utils.graph import DeviceProgram

    prog = DeviceProgram({"x": torch.zeros(3, device=cuda)})

    def host_read(state, inputs):
        n = int(inputs["y"].sum())
        return {"x": state["x"] + n}, {}

    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture"):
            prog(host_read, {"y": torch.ones(2, device=cuda)})
    torch.cuda.synchronize()
    assert prog.state["x"].tolist() == [4.0, 4.0, 4.0]


# --- the step's branches as CUDA-graph IF nodes (utils/control.py) --------

_BRANCH_CASES = {
    # raytrace_every, staging frames, frame count, jump_at (the cases of
    # tests/test_torch_pipeline.py)
    "jump_on_keyframe": (1, 3, 8, 3),
    "staging_full_on_keyframe": (1, 4, 10, 5),
    "raytrace_every_3": (3, 3, 8, 3),
}


def _branch_cfg(every, staging, L=300):
    cfg = benchmark_config(length=L, max_points=4096)
    return cfg.replace(raytrace_every=every, submap=dataclasses.replace(
        cfg.submap, keyframe_distance=1.0, staging_frames=staging,
        capacity=4096, max_submaps=4, store_ortho=True,
        keyframe_scan_points=64))


def _branch_frames(cfg, device, n, jump_at, seed):
    """n frames at 0.35 m per frame; frame `jump_at` closes a loop (pose
    +0.5 m, z +0.3 m), the next three hold the jumped z (the jump settles),
    the frame after bumps z (it finishes); frame 6 is all padding."""
    from gem_tpu_torch.io.replay import synthetic_frames

    fr = [f for f, _, _ in synthetic_frames(cfg, n, n_points=3000,
                                            speed=0.35, seed=seed,
                                            max_range=2.4, device=device)]
    jz = None
    for i in range(jump_at, n):
        tr = fr[i].track_position.clone()
        if i == jump_at:
            tr += torch.tensor([0.5, 0.0, 0.3], device=device)
            jz = tr[2].clone()
            fr[i] = dataclasses.replace(fr[i], track_position=tr,
                                        loop_closure=torch.ones(
                                            (), dtype=torch.bool,
                                            device=device))
            continue
        tr[0] += 0.5
        tr[2] = jz if i < jump_at + 4 else jz + 0.05
        fr[i] = dataclasses.replace(fr[i], track_position=tr)
    fr[6] = dataclasses.replace(fr[6], valid=torch.zeros_like(fr[6].valid))
    return fr


_RINGS = ("slots", "orthos", "kf_points", "kf_counts", "counts", "poses")


@pytest.mark.parametrize("case", sorted(_BRANCH_CASES))
def test_graph_branches_equal_eager_bitwise(cuda, case):
    """L=300, the frames where the step's four conds meet: the replayed
    graph (one robot: IF nodes, only the taken side runs) against the eager
    `step` (the select route: both sides), every state leaf and output
    bitwise after every frame, with no host sync.  On every frame whose
    keyframe is not due, the skipped finalize leaves the submap rings'
    bytes as they were."""
    from gem_tpu_torch.mapping.pipeline import (ElevationPipeline,
                                                init_pipeline_state, step)
    from gem_tpu_torch.utils.tree import tree_leaves, tree_map

    every, staging, n, jump_at = _BRANCH_CASES[case]
    cfg = _branch_cfg(every, staging)
    frames = _branch_frames(cfg, cuda, n, jump_at, seed=11 + n + jump_at)
    frames = [dataclasses.replace(f, loop_closure=torch.zeros(
        (), dtype=torch.bool, device=cuda)) if f.loop_closure is None
        else f for f in frames]
    pipe = ElevationPipeline(cfg, device=cuda)
    state = init_pipeline_state(cfg, cuda)
    S = staging
    events = []
    before = torch.cuda.get_sync_debug_mode()
    for i, f in enumerate(frames):
        full = int(state.submaps.staging_used) == S - 1
        rings = {k: tree_map(torch.clone, getattr(pipe.state.submaps, k))
                 for k in _RINGS}
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipe.process(f)
            state, ref = step(state, f, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(before)
        assert not _leaves_equal(pipe.state, state), (i, _leaves_equal(
            pipe.state, state))
        assert not _leaves_equal(out, ref), (i, _leaves_equal(out, ref))
        key = bool(ref.keyframe_due)
        if not key and i > 0:
            for k, old in rings.items():
                now = tree_leaves(getattr(pipe.state.submaps, k))
                for name, t in tree_leaves(old).items():
                    assert torch.equal(now[name], t), (i, k, name)
        events.append((bool(state.jump_odom), key, full))
    if case == "jump_on_keyframe":
        assert any(j and k for j, k, _ in events), events
    elif case == "staging_full_on_keyframe":
        assert any(k and f and not j for j, k, f in events), events
    else:
        assert any(k for _, k, _ in events), events


def test_captured_step_holds_conditional_nodes(cuda):
    """The step captured for one robot holds one IF node per branch side,
    in the step's order: jump vs move (2), the staging flush (1), the
    raytrace cadence (2), the keyframe finalize (1); the fleet's batched
    step (R = 2) holds none."""
    from gem_tpu_torch.mapping.pipeline import (batched_step,
                                                init_pipeline_state, step,
                                                stack_frames)
    from gem_tpu_torch.utils import control
    from gem_tpu_torch.utils.tree import tree_map

    cfg = _branch_cfg(3, 3, L=64)
    f = _branch_frames(cfg, cuda, 8, 3, seed=1)[3]
    state = init_pipeline_state(cfg, cuda)
    two = tree_map(lambda x: torch.stack([x, x]), state)
    frames = stack_frames([f, f])
    step(state, f, cfg)                   # the eager warm-up
    batched_step(two, frames, cfg)
    torch.cuda.synchronize()
    counts = {}
    for name, run in (("one", lambda: step(state, f, cfg)),
                      ("fleet", lambda: batched_step(two, frames, cfg))):
        control.IF_NODES.clear()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, pool=torch.cuda.graph_pool_handle()):
            run()
        counts[name] = (control.count_graph_nodes(g), list(control.IF_NODES))
        del g
    (nodes, conditional, work), log = counts["one"]
    assert conditional == 6 and len(log) == 6, (counts["one"])
    assert [name for name, _ in log] == [
        "_move_branch", "_jump_branch", "flush_staging", "_raytrace",
        "_unchanged", "_finalize"], log
    assert all(w > 0 for name, w in log if name != "_unchanged"), log
    assert nodes > work > 0
    assert counts["fleet"][0][1] == 0 and counts["fleet"][1] == []


def test_capture_without_conditional_nodes_raises(cuda, monkeypatch):
    """With the conditional-node entry point gone, the capture of a single
    robot's step raises, naming the cond, and keeps no graph; nothing
    falls back to the selects."""
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline
    from gem_tpu_torch.utils import control

    def gone(*args):
        raise control.BranchError("no conditional nodes")

    monkeypatch.setattr(control, "_begin_if_node", gone)
    cfg = _graph_cfg()
    frames = _graph_frames(cfg, cuda)
    pipe = ElevationPipeline(cfg, device=cuda)
    for f in frames[:2]:
        with pytest.raises(RuntimeError,
                           match=r"capture of step failed: cond\(_move"):
            pipe.process(f)
    assert not pipe._program._graphs
    torch.cuda.synchronize()
    assert int(pipe.state.frame_idx) == 2     # the eager runs, then raised


# --- the tracer's stamps (utils/observability.py) --------------------------


@pytest.fixture
def tracer():
    from gem_tpu_torch.utils.observability import TRACER

    TRACER.enable(False)
    TRACER.reset()
    yield TRACER
    TRACER.enable(False)
    TRACER.reset()


def test_captured_step_stamps_only_with_the_tracer_on(cuda, tracer):
    """Off, the step's capture holds no stamp: the same nodes as before the
    tracer existed.  On, one kernel node per stage mark at the top level
    (move, pointproc, fuse, motion, features, shed, raytrace, keyframe) and
    one more in each of the flush and finalize bodies."""
    from gem_tpu_torch.mapping.pipeline import init_pipeline_state, step
    from gem_tpu_torch.utils import control

    cfg = _branch_cfg(3, 3, L=64)
    f = _branch_frames(cfg, cuda, 8, 3, seed=1)[3]
    state = init_pipeline_state(cfg, cuda)
    with tracer.enabled():
        step(state, f, cfg)               # the eager warm-up, the ring
    torch.cuda.synchronize()
    counts = {}
    for on in (False, True):
        tracer.enable(on)
        control.IF_NODES.clear()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, pool=torch.cuda.graph_pool_handle()):
            step(state, f, cfg)
        counts[on] = (control.count_graph_nodes(g), dict(control.IF_NODES))
        del g
    (n0, c0, w0), b0 = counts[False]
    (n1, c1, w1), b1 = counts[True]
    assert (n1 - n0, c1 - c0, w1 - w0) == (8, 0, 8), counts
    assert {k: b1[k] - b0[k] for k in b0} == {
        "_move_branch": 0, "_jump_branch": 0, "flush_staging": 1,
        "_raytrace": 0, "_unchanged": 0, "_finalize": 1}, counts


def test_program_stamps_every_replayed_frame(cuda, tracer):
    """ElevationPipeline with the tracer on captures once, then replays:
    each frame's row holds its stages in order, and the flush and finalize
    bodies' stamps are the frame's own only on the frames that take them;
    the state is bitwise the one without the tracer.  Turning the tracer
    off drops the graph and captures one without stamps, which leaves the
    ring alone; turning it on again drops that one in turn."""
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline
    from gem_tpu_torch.utils.observability import COLUMN, stage_ns, taken

    cfg = _graph_cfg()
    frames = [f for f, _, _ in synthetic_frames(
        cfg, 12, n_points=3000, speed=0.35, seed=2, max_range=3.0,
        device=cuda)]
    plain = ElevationPipeline(cfg, device=cuda)
    for f in frames:
        plain.process(f)
    tracer.enable()
    pipe = ElevationPipeline(cfg, device=cuda)
    S = cfg.submap.staging_frames
    took = []
    for i, f in enumerate(frames):
        full = int(pipe.state.submaps.staging_used) == S - 1
        out = pipe.process(f)
        took.append((bool(out.keyframe_due), full))
        if i == 0:
            assert tracer.counts["program.captures"] == 1
    assert tracer.counts["program.captures"] == 1
    assert tracer.counts["program.replays"] == len(frames) - 1
    assert not _leaves_equal(plain.state, pipe.state)
    assert any(k for k, _ in took[1:]) and any(f for _, f in took[1:])
    ring = tracer.ring(cuda)
    order = ["program.in", "move", "pointproc", "fuse", "motion", "features",
             "shed", "raytrace", "keyframe", "write_back", "program.out"]
    for (key, flush), r in list(zip(took, tracer.recent_rows(
            cuda, len(frames))))[1:]:
        row = ring[r]
        stamps = [row[COLUMN[s]] for s in order]
        assert stamps == sorted(stamps) and stamps[0] > 0
        assert taken(row, "program.in", "flush") == flush
        assert taken(row, "program.in", "finalize") == key
        assert len(stage_ns(row, "program.in")) == 8
    tracer.enable(False)
    before = tracer.ring(cuda)
    pipe.process(frames[0])
    pipe.process(frames[1])
    assert len(pipe._program._graphs) == 1
    np.testing.assert_array_equal(tracer.ring(cuda), before)
    tracer.enable()
    pipe.process(frames[2])
    assert len(pipe._program._graphs) == 1
    assert tracer.counts["program.graphs_dropped"] == 1  # counted while on
    assert tracer.counts["program.captures"] == 2
