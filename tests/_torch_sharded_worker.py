"""Worker for tests/test_torch_sharded.py: one rank of a 4-process gloo group
running the port's distributed modules on the CPU.  It imports no jax.

Started by `torch.multiprocessing` (spawn) as run(rank, world, store_path,
out_dir); writes `out_dir/rank<r>.npz` with everything the parent compares
against the JAX package.  Inside the one group:

  * world 4 (the default group), world 2 (ranks 0-1) and world 1 (rank 0)
    run `apply_sharded_loop_closure` on every scenario of `lc_scenarios()`;
  * `sharded_features` on world 4 for `feature_inputs()`;
  * `ring_shift` / `ring_shift_tensors` in both directions (checked here);
  * a sharded checkpoint round trip on ranks 0-1;
  * `barrier`, `local_robots`, `distribute_fleet`.
"""

from __future__ import annotations

import os

import numpy as np

_FIELDS = ("x", "y", "z", "variance", "intensity", "traver", "color",
           "valid")


def _grid(x, y, z, v):
    n = len(x)
    return {"x": np.asarray(x, np.float32), "y": np.asarray(y, np.float32),
            "z": np.asarray(z, np.float32),
            "variance": np.asarray(v, np.float32),
            "intensity": np.zeros(n, np.float32),
            "traver": np.full(n, 0.5, np.float32),
            "color": np.zeros(n, np.int32), "valid": np.ones(n, bool)}


def _pose(x):
    return np.asarray([x, 0, 0, 1, 0, 0, 0], np.float32)


def lc_scenarios():
    """{name: (config kwargs, [(grid dict, pose (7,))], opt_poses)}: the four
    stores of tests/test_sharded_global.py, built by finalize_submap in
    order, and a denser ring (8 slots of 256 cell-center points, 11
    keyframes so the ring wraps) where most pairs re-fuse across shards."""
    out = {}
    line = lambda n: [(_grid([i * 3.0, i * 3.0 + 0.6], [0.0, 0.0],
                             [0.1 * i, 0.1 * i + 1.0], [0.05, 0.2]),
                       _pose(i * 3.0)) for i in range(n)]
    small = dict(length=8, resolution=0.5, max_submaps=8, capacity=16)
    subs = line(6)
    opt = np.stack([p for _, p in subs]).copy()
    opt[:, 0] += np.linspace(0, 1, 6).astype(np.float32)
    out["transforms"] = (dict(small, overlap_radius=4.0), subs, opt)
    two = [(_grid([1.0], [1.0], [z], [v]), _pose(0.0))
           for z, v in [(0.0, 0.1), (2.0, 0.3)]]
    out["refuse"] = (dict(small, overlap_radius=50.0), two,
                     np.stack([p for _, p in two]))
    four = [(_grid([1.0], [1.0], [z], [v]), _pose(0.0))
            for z, v in [(0.0, 0.1), (2.0, 0.3), (4.0, 0.2), (6.0, 0.4)]]
    out["uncorrected"] = (dict(small, overlap_radius=50.0), four,
                          np.stack([p for _, p in four[:2]]))
    subs = line(11)
    opt = np.zeros((11, 7), np.float32)
    opt[:, 3] = 1.0
    opt[:, 0] = np.arange(11) * 3.0 + 0.1 * np.arange(11)
    out["wrapped"] = (dict(small, overlap_radius=4.0), subs, opt)
    rng = np.random.default_rng(7)
    res = 0.25
    dense = []
    for k in range(11):
        cx, cy = 2.0 * np.cos(k), 2.0 * np.sin(k)
        gx = np.round(cx / res) + rng.integers(-8, 8, 256)
        gy = np.round(cy / res) + rng.integers(-8, 8, 256)
        dense.append((_grid((gx + 0.5) * res, (gy + 0.5) * res,
                            rng.normal(0, 0.3, 256),
                            rng.uniform(0.01, 0.99, 256)),
                      np.asarray([cx, cy, 0, 1, 0, 0, 0], np.float32)))
    opt = np.stack([p for _, p in dense]).copy()
    opt[1:, :2] += res * rng.integers(-2, 3, (10, 2))
    out["dense_wrapped"] = (dict(length=8, resolution=res, max_submaps=8,
                                 capacity=256, overlap_radius=25.0),
                            dense, opt)
    return out


def feature_inputs():
    """{name: (L, resolution, elevation)}: terrain-like relief with 20% of
    the cells invalid, and a flat fully valid plane (the masked edge
    rows)."""
    rng = np.random.default_rng(3)
    g = np.arange(64) * 0.25
    terrain = (0.5 * np.sin(g[:, None] / 2.0) + 0.4 * np.cos(g[None, :] / 3.0)
               + 0.01 * rng.normal(size=(64, 64))).astype(np.float32)
    terrain[rng.random((64, 64)) < 0.2] = -10.0
    return {"terrain": (64, 0.25, terrain),
            "flat": (32, 0.25, np.full((32, 32), 1.0, np.float32))}


def port_config(kw):
    from gem_tpu_torch.config import MapConfig, PipelineConfig, SubmapConfig

    return PipelineConfig(
        map=MapConfig(length=kw["length"], resolution=kw["resolution"]),
        submap=SubmapConfig(max_submaps=kw["max_submaps"],
                            capacity=kw["capacity"],
                            overlap_radius=kw["overlap_radius"]))


def port_store(cfg, submaps):
    import torch

    from gem_tpu_torch.global_map import submaps as sm

    store = sm.init_store(cfg, "cpu")
    for grid, pose in submaps:
        buf = sm.PointBuffer(**{k: torch.from_numpy(grid[k])
                                for k in _FIELDS})
        store = sm.finalize_submap(store, buf, torch.from_numpy(pose))
    return store


def _fleet_cfg():
    from gem_tpu_torch.config import (BodyFilterConfig, MapConfig,
                                      PipelineConfig, SensorConfig,
                                      SubmapConfig)

    return PipelineConfig(
        map=MapConfig(length=16, resolution=0.25, max_shift_cells=4),
        sensor=SensorConfig(model="laser"),
        body_filter=BodyFilterConfig(mode="none"),
        submap=SubmapConfig(max_submaps=2, capacity=64, staging_frames=3,
                            keyframe_distance=3.0),
        max_points=128)


def run(rank, world, store_path, out_dir):
    import torch
    import torch.distributed as dist

    from gem_tpu_torch.global_map.sharded import (apply_sharded_loop_closure,
                                                  shard_store)
    from gem_tpu_torch.io.checkpoint import (load_checkpoint_sharded,
                                             save_checkpoint_sharded)
    from gem_tpu_torch.multirobot import distributed as mdist
    from gem_tpu_torch.multirobot.fleet import make_fleet_state
    from gem_tpu_torch.multirobot.spatial import (place_row_sharded,
                                                  sharded_features)
    from gem_tpu_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    mdist.initialize(store_path, world, rank, backend="gloo", timeout_s=120)
    out = {}
    # every rank creates every group, in the same order
    groups = {4: None, 2: dist.new_group([0, 1]),
              1: [dist.new_group([r]) for r in range(world)][rank]}
    members = {4: range(4), 2: range(2), 1: range(1)}

    for name, (kw, submaps, opt) in lc_scenarios().items():
        cfg = port_config(kw)
        store = port_store(cfg, submaps)
        for w, g in groups.items():
            if rank not in members[w]:
                continue
            got, stats = apply_sharded_loop_closure(shard_store(store, g),
                                                    cfg, opt, g)
            pre = f"lc/{name}/w{w}/"
            for k in ("x", "y", "z", "variance"):
                out[pre + k] = getattr(got.slots, k).numpy()
            out[pre + "poses"] = got.poses.numpy()
            out[pre + "centers"] = got.centers.numpy()
            out[pre + "n_corrected"] = np.int64(stats["n_corrected"])
            out[pre + "n_cells_fused"] = np.int64(stats["n_cells_fused"])

    from gem_tpu_torch.config import MapConfig

    for name, (L, res, elev) in feature_inputs().items():
        mcfg = MapConfig(length=L, resolution=res)
        slope, rough, traver = sharded_features(mcfg)(
            place_row_sharded(torch.from_numpy(elev)))
        for k, v in (("slope", slope), ("rough", rough), ("traver", traver)):
            out[f"features/{name}/{k}"] = v.numpy()

    # ring_shift: a mixed-dtype payload moves one rank on, both directions
    mine = [torch.full((3, 5), float(rank)), torch.arange(4) + 10 * rank,
            torch.tensor([rank % 2 == 1, True]),
            torch.full((2,), rank, dtype=torch.int32)]
    for d in (1, -1):
        src = (rank - d) % world
        got = mdist.ring_shift_tensors(mine, direction=d)
        want = [torch.full((3, 5), float(src)), torch.arange(4) + 10 * src,
                torch.tensor([src % 2 == 1, True]),
                torch.full((2,), src, dtype=torch.int32)]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (d, a, b)
        one = mdist.ring_shift(torch.tensor([rank]), direction=d)
        assert int(one) == src
    out["ring_ok"] = np.int64(1)

    # sharded checkpoint on ranks 0-1: each saves and restores its robots
    if rank in members[2]:
        g = groups[2]
        cfg = _fleet_cfg()
        robots = mdist.local_robots(4, g)
        state = make_fleet_state(cfg, len(robots), "cpu")
        gen = torch.Generator().manual_seed(100 + rank)
        for leaf in tree_leaves(state).values():
            if leaf.dtype == torch.bool:
                leaf.copy_(torch.rand(leaf.shape, generator=gen) < 0.5)
            elif leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
            else:
                leaf.copy_(torch.randint(-50, 50, leaf.shape, generator=gen))
        ck = os.path.join(out_dir, "ck")
        save_checkpoint_sharded(ck, state, group=g)
        back = load_checkpoint_sharded(ck, cfg, robots, device="cpu",
                                       group=g)
        a, b = tree_leaves(state), tree_leaves(back)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert back.submaps.staging.x.shape[1] == 0   # fleet config
        out["ck/robots"] = np.asarray([robots.start, robots.stop])
        out["ck/elevation"] = back.map.elevation.numpy()
        out["ck/kf_ids"] = back.submaps.kf_ids.numpy()

    # barrier, the robot split, distribute_fleet
    mdist.barrier("worker_end", timeout_ms=60_000)
    assert list(mdist.local_robots(8)) == [2 * rank, 2 * rank + 1]
    try:
        mdist.local_robots(6)
        raise AssertionError("6 robots split over 4 ranks")
    except ValueError:
        pass
    fleet = mdist.distribute_fleet({"a": torch.zeros(2, 3)})
    assert fleet["a"].device.type == "cpu"
    assert mdist.local_values(fleet)["a"].shape == (2, 3)
    assert mdist.global_group() is dist.group.WORLD
    try:
        mdist.distribute_fleet({"a": torch.zeros(1 + (rank == 3), 3)})
        raise AssertionError("uneven fleets accepted")
    except ValueError:
        pass
    out["rank"] = np.int64(rank)
    out["world"] = np.int64(dist.get_world_size())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    mdist.barrier("saved", timeout_ms=60_000)
    mdist.shutdown()
