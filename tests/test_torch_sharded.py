"""The port's process-group modules against the JAX package's mesh:
`apply_sharded_loop_closure` (gem_tpu_torch/global_map/sharded.py), the
halo-exchanged feature stencil (multirobot/spatial.py), `ring_shift` and the
rest of multirobot/distributed.py, and the sharded checkpoints
(io/checkpoint.py).

JAX side: the 8-device virtual CPU mesh of tests/conftest.py, a 4-shard
`make_mesh(4, "shard")` as in tests/test_sharded_global.py.  Port side: one
group of 4 gloo processes on the CPU (`torch.multiprocessing`, spawn, over a
FileStore), started once for the file by the `ranks` fixture; the workers
(tests/_torch_sharded_worker.py) import no jax and write their shards to
npz files.  World 2 and world 1 run on subgroups of the same processes.

Bounds: the sharded loop closure's x and y bitwise (identity rotations,
every correction a translation), z and variance within 1e-5, the stats
equal; the same on world 1, 2 and 4 (a slot meets the others in ring order,
which depends on the world size, so z and variance round differently).
The stencil is bitwise the port's unsharded plain version; against JAX's
sharded stencil, roughness within 1e-5 and slope and traversability within
the eigen-gap-scaled bound of tests/test_torch_features.py (1e-5 where the
fit is well conditioned; a flat plane's normal is where one ULP of
normal_z is ~3e-4 rad of slope).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import gem_tpu.config as jconfig
from gem_tpu.global_map import submaps as jsm
from gem_tpu.global_map.sharded import (apply_sharded_loop_closure,
                                        shard_store)
from gem_tpu.kernels.features import compute_features as jcompute
from gem_tpu.core.state import init_map_state as jinit_map
from gem_tpu.multirobot.fleet import make_mesh
from gem_tpu.multirobot.spatial import place_row_sharded, sharded_features

from gem_tpu_torch import config as tconfig
from gem_tpu_torch.core.state import init_map_state
from gem_tpu_torch.kernels.features import compute_features

import _torch_sharded_worker as worker
from test_torch_features import _relative_gap

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs the 4-device mesh")

WORLD = 4
JOIN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four workers' results: {rank: npz dict}."""
    d = str(tmp_path_factory.mktemp("ranks"))
    ctx = mp.start_processes(worker.run,
                             args=(WORLD, os.path.join(d, "store"), d),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"gloo workers still running after "
                                     f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return {r: dict(np.load(os.path.join(d, f"rank{r}.npz")))
            for r in range(WORLD)}


def _jax_cfg(kw):
    return jconfig.PipelineConfig(
        map=jconfig.MapConfig(length=kw["length"],
                              resolution=kw["resolution"]),
        submap=jconfig.SubmapConfig(max_submaps=kw["max_submaps"],
                                    capacity=kw["capacity"],
                                    overlap_radius=kw["overlap_radius"]))


def _jax_store(cfg, submaps):
    store = jsm.init_store(cfg)
    for grid, pose in submaps:
        store = jsm.finalize_submap(store, jsm.PointBuffer(
            **{k: jnp.asarray(v) for k, v in grid.items()}), pose)
    return store


def _gather(ranks, name, world, key):
    """Concatenate the shards of one result over the ranks of `world`."""
    return np.concatenate([ranks[r][f"lc/{name}/w{world}/{key}"]
                           for r in range(world)])


@pytest.mark.parametrize("name", list(worker.lc_scenarios()))
def test_sharded_loop_closure_matches_jax(ranks, name):
    kw, submaps, opt = worker.lc_scenarios()[name]
    cfg = _jax_cfg(kw)
    mesh = make_mesh(4, axis="shard")
    got, stats = apply_sharded_loop_closure(
        shard_store(_jax_store(cfg, submaps), mesh), cfg, opt, mesh)
    want = {k: np.asarray(jax.device_get(getattr(got.slots, k)))
            for k in ("x", "y", "z", "variance")}
    want["poses"] = np.asarray(jax.device_get(got.poses))
    want["centers"] = np.asarray(jax.device_get(got.centers))
    for k in ("x", "y", "poses", "centers"):
        np.testing.assert_array_equal(_gather(ranks, name, 4, k), want[k],
                                      err_msg=k)
    for k in ("z", "variance"):
        np.testing.assert_allclose(_gather(ranks, name, 4, k), want[k],
                                   rtol=0, atol=1e-5, err_msg=k)
    for k in ("n_corrected", "n_cells_fused"):
        for r in range(4):
            assert int(ranks[r][f"lc/{name}/w4/{k}"]) == stats[k], (r, k)
    if name in ("refuse", "uncorrected", "dense_wrapped"):
        assert stats["n_cells_fused"] > 0


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_loop_closure_same_on_every_world(ranks, world):
    for name in worker.lc_scenarios():
        for k in ("x", "y", "poses", "centers"):
            np.testing.assert_array_equal(_gather(ranks, name, world, k),
                                          _gather(ranks, name, 4, k),
                                          err_msg=f"{name} {k}")
        for k in ("z", "variance"):
            np.testing.assert_allclose(_gather(ranks, name, world, k),
                                       _gather(ranks, name, 4, k),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name} {k}")
        for k in ("n_corrected", "n_cells_fused"):
            assert int(ranks[0][f"lc/{name}/w{world}/{k}"]) \
                == int(ranks[0][f"lc/{name}/w4/{k}"])


@pytest.mark.parametrize("name", list(worker.feature_inputs()))
def test_sharded_features_match_jax_and_unsharded(ranks, name):
    L, res, elev = worker.feature_inputs()[name]
    got = {k: np.concatenate([ranks[r][f"features/{name}/{k}"]
                              for r in range(4)])
           for k in ("slope", "rough", "traver")}
    mesh = make_mesh(4, axis="shard")
    jcfg = jconfig.MapConfig(length=L, resolution=res)
    jout = sharded_features(jcfg, mesh)(place_row_sharded(jnp.asarray(elev),
                                                          mesh))
    tcfg = tconfig.MapConfig(length=L, resolution=res)
    ref = compute_features(init_map_state(tcfg, "cpu").replace(
        elevation=torch.from_numpy(elev)), tcfg)
    jref = jcompute(jinit_map(jcfg).replace(elevation=jnp.asarray(elev)),
                    jcfg)
    nz = np.asarray(jref.normal_z).astype(np.float64)
    tol = np.maximum(1e-5, 8e-6 / np.maximum(
        _relative_gap(elev, (0, 0), jcfg), 1e-30))
    tol = tol / np.sqrt(np.maximum(1.0 - nz * nz, 1e-12))
    tol = np.where(nz > 1.0 - 1e-6, np.maximum(tol, 1e-3), tol)
    for k, j in zip(("slope", "rough", "traver"), jout):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(),
                                      err_msg=k)
        for want in (np.asarray(jax.device_get(j)),
                     np.asarray(getattr(jref, k))):
            d = np.abs(got[k] - want)
            assert (d <= (1e-5 if k == "rough" else tol)).all(), \
                (k, float(d.max()))
    if name == "terrain":       # well conditioned nearly everywhere
        assert (np.abs(got["slope"] - np.asarray(jax.device_get(jout[0])))
                <= 1e-5).mean() > 0.99
    # the first and last rows see the map's edge, not a neighbour's rows
    assert (got["traver"] != -10.0).sum() > 0.5 * L * L


def test_ring_shift_moves_mixed_payloads(ranks):
    """Checked inside the workers: each rank received its predecessor's
    (direction 1) and successor's (direction -1) float, int64, bool and
    int32 tensors, in one packed byte tensor."""
    assert all(int(ranks[r]["ring_ok"]) == 1 for r in range(4))
    assert [int(ranks[r]["world"]) for r in range(4)] == [4] * 4


def test_sharded_checkpoint_restores_each_ranks_robots(ranks):
    """Two ranks save their own robots (distinct random states) into one
    checkpoint and restore them bitwise (checked in the workers); rank 1
    gets its own robots back, not rank 0's."""
    assert ranks[0]["ck/robots"].tolist() == [0, 2]
    assert ranks[1]["ck/robots"].tolist() == [2, 4]
    assert not np.array_equal(ranks[0]["ck/elevation"],
                              ranks[1]["ck/elevation"])
    assert not np.array_equal(ranks[0]["ck/kf_ids"], ranks[1]["ck/kf_ids"])
    assert "ck/robots" not in ranks[2]


@pytest.mark.parametrize("place", ["place_row_sharded", "distribute_fleet"])
def test_no_group_keeps_the_callers_device(place):
    """Without a process group a tensor stays on the device it was given
    (a meta tensor stands in for one on a card): nothing moves it to the
    CPU behind the caller's back."""
    import torch.distributed as dist

    from gem_tpu_torch.multirobot import distributed as mdist
    from gem_tpu_torch.multirobot import spatial

    assert not dist.is_initialized()
    assert mdist.device() is None
    x = torch.empty((8, 8), device="meta")
    if place == "place_row_sharded":
        got = spatial.place_row_sharded(x)
    else:
        got = mdist.distribute_fleet({"a": x})["a"]
    assert got.device.type == "meta" and got.shape == (8, 8)


@pytest.mark.parametrize("coordinator,want", [
    ("localhost:29500", ("localhost", 29500)),
    ("10.0.0.2:1234", ("10.0.0.2", 1234)),
    ("[::1]:8000", ("[::1]", 8000)),
    ("store", None),
    ("/tmp/run/store", None),
    ("runs/host:12", None),
    ("host:port", None),
])
def test_coordinator_is_tcp_only_as_host_port(coordinator, want):
    from gem_tpu_torch.multirobot.distributed import tcp_address

    assert tcp_address(coordinator) == want


def test_initialize_takes_a_bare_filename_as_a_file_store(tmp_path,
                                                         monkeypatch):
    """`--coordinator store` (a relative path with no separator) joins a
    group over a FileStore."""
    import torch.distributed as dist

    from gem_tpu_torch.multirobot import distributed as mdist

    monkeypatch.chdir(tmp_path)
    mdist.initialize("store", 1, 0, backend="gloo", timeout_s=30)
    try:
        assert dist.get_world_size() == 1
        assert mdist.device() == torch.device("cpu")
        assert mdist.all_reduce_sum(3) == 3
    finally:
        mdist.shutdown()
