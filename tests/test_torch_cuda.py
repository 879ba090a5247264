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
                                    seed=1, max_range=3.0):
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
                                    seed=2, max_range=3.0):
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
