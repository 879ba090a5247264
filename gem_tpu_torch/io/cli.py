"""Command line interface: `python -m gem_tpu_torch <cmd>`.

Counterpart of gem_tpu/io/cli.py with the same flag names:

  gem_tpu_torch run       replay a dataset (synthetic | npz dir) through the
                          pipeline, re-stitch after a loop closure
                          (--keyframes / --loop-demo) and write its map
                          products (--save-octomap, --dense, ...)
  gem_tpu_torch fleet     a robot fleet's synthetic drives through the fleet
                          step: one process (vmap), one per card (--mesh)
                          or one per host (--coordinator); inter-robot loop
                          detection and re-stitch (--loop-detect)
  gem_tpu_torch selftest  the production step on --device against the
                          segment backend on the CPU; exit 0 = healthy
  gem_tpu_torch viz       render a PCD to a top-down PNG (needs matplotlib)
  gem_tpu_torch info      environment + config dump

`--device {cuda,cpu}` takes the place of `--platform`; `--device cuda`
without a card is an error, never a silent CPU run.  `--fuse-backend auto`
means `stream`.  The `bench` subcommand is not ported (a benchmark's work,
ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gem_tpu_torch import msgs, native
from gem_tpu_torch.global_map import octomap_io
from gem_tpu_torch.io import pcd
from gem_tpu_torch.sensors import catalog
from gem_tpu_torch.utils import image as image_mod

_FIELDS = ("x", "y", "z", "color", "intensity", "variance", "traver", "valid")


def _build_config(args):
    from gem_tpu_torch import config as C

    if args.config:
        cfg = C.config_from_yaml(args.config)
    elif args.preset == "kitti":
        cfg = C.kitti_config()
    elif args.preset == "yq":
        cfg = C.yq_config()
    elif args.preset == "benchmark":
        cfg = C.benchmark_config()
    else:
        cfg = C.PipelineConfig()
    if args.max_points:
        cfg = cfg.replace(max_points=args.max_points)
    if args.sensor:
        cfg = cfg.replace(sensor=catalog.sensor_preset(args.sensor))
    if args.camera:
        d = np.load(args.camera)
        cfg = cfg.replace(camera=C.CameraConfig(
            image_height=int(d["image_height"]),
            image_width=int(d["image_width"]),
            projection=tuple(float(v) for v in d["projection"])))
    return cfg


def _device(args) -> torch.device:
    from gem_tpu_torch.utils.device import resolve_device

    return resolve_device(args.device)


def _frames(cfg, args, device):
    from gem_tpu_torch.io.replay import load_npz_frame, synthetic_frames

    if args.dataset == "synthetic":
        for frame, _, _ in synthetic_frames(cfg, args.frames,
                                            speed=args.speed,
                                            seed=args.seed, device=device):
            yield frame
        return
    paths = sorted(glob.glob(os.path.join(args.dataset, "*.npz")))
    if not paths:
        sys.exit(f"no .npz frames under {args.dataset}")
    paths = paths[: args.frames or None]
    # the native background loader overlaps file IO with device compute
    pf = native.FramePrefetcher(paths, ring=4)
    try:
        for i in range(len(pf)):
            yield load_npz_frame(cfg, pf[i], device=device)
    finally:
        pf.close()


def _numpy(t):
    return t.detach().cpu().numpy()


def _global_cloud(pipe, cfg):
    """Global cloud = finalized submaps + accumulator + staged bands + live
    grid (savingMap, src/ElevationMapping.cpp:430-455), as NumPy arrays."""
    from gem_tpu_torch.render import grid_point_cloud

    s = pipe.state.submaps
    parts = []
    for i in range(min(int(s.num_submaps), s.counts.shape[0])):
        parts.append({f: _numpy(getattr(s.slots, f)[i]) for f in _FIELDS})
    parts.append({f: _numpy(getattr(s.accum, f)) for f in _FIELDS})
    if s.staging.x.shape[0]:          # staged-but-unflushed shed bands
        parts.append({f: _numpy(getattr(s.staging, f)).reshape(-1)
                      for f in _FIELDS})
    traver = pipe.last_outputs.features.traver if pipe.last_outputs \
        else None
    pc = grid_point_cloud(pipe.state.map, cfg.map, traver)
    grid = {f: _numpy(pc[f]) for f in _FIELDS if f != "color"}
    grid["color"] = _numpy(pipe.state.map.color).reshape(-1)
    parts.append(grid)
    return {f: np.concatenate([p[f] for p in parts]) for f in _FIELDS}


def _save_global_pcd(pipe, cfg, path):
    cat = _global_cloud(pipe, cfg)
    # min-variance record per cell through the native spatial hash (the
    # reference dedups through its unordered_map on insert)
    kept = native.dedup_cells(cat["x"], cat["y"], cat["variance"],
                              cat["valid"], cfg.map.resolution)
    cat = {k: v[kept] for k, v in cat.items()}
    return pcd.save_pcd(
        path, cat["x"], cat["y"], cat["z"], cat["color"], cat["intensity"],
        cat["variance"], cat["traver"], valid=cat["valid"])


def _costmap_png(traver, start, cfg, args):
    """Traversability -> costmap_2d values -> InflationLayer -> colored
    image (the reference's doc/costmap.png analogue)."""
    from gem_tpu_torch.render import (FREE_SPACE, INSCRIBED_INFLATED,
                                      LETHAL_OBSTACLE, NO_INFORMATION,
                                      costmap_from_traversability,
                                      inflate_costmap)

    cm = costmap_from_traversability(traver, cfg.traversability_threshold,
                                     start=start)
    cm = _numpy(inflate_costmap(
        cm, args.inflation_radius / cfg.map.resolution,
        cost_scaling_factor=args.cost_scaling,
        resolution=cfg.map.resolution, inscribed_radius=cfg.map.resolution))
    img = np.zeros(cm.shape + (3,), np.uint8)
    img[cm == NO_INFORMATION] = (70, 70, 70)
    img[cm == FREE_SPACE] = (255, 255, 255)
    ramp = (cm > FREE_SPACE) & (cm < INSCRIBED_INFLATED)
    t = cm[ramp].astype(np.float32) / INSCRIBED_INFLATED
    img[ramp] = np.stack([np.full_like(t, 255.0), 230.0 * (1.0 - t),
                          np.zeros_like(t)], axis=-1).astype(np.uint8)
    img[cm == INSCRIBED_INFLATED] = (255, 0, 0)
    img[cm == LETHAL_OBSTACLE] = (40, 0, 60)
    return img, int((cm == LETHAL_OBSTACLE).sum())


def cmd_run(args):
    from gem_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from gem_tpu_torch.mapping.pipeline import (ElevationPipeline,
                                                state_to_numpy)
    from gem_tpu_torch.utils.observability import MetricsLogger, trace

    dev = _device(args)
    cfg = _build_config(args)
    backend = "stream" if args.fuse_backend == "auto" else args.fuse_backend
    pipe = ElevationPipeline(cfg, device=dev, fuse_backend=backend)
    if args.resume:
        pipe.state, _ = load_checkpoint(args.resume, cfg, device=dev)
        print(f"resumed from {args.resume} "
              f"(frame {int(pipe.state.frame_idx)})")

    metrics_log = MetricsLogger(args.metrics_out)
    t0 = last_t = time.time()
    n = 0
    batch = []
    scan = args.scan if args.scan and args.scan > 1 else 0
    with trace(args.profile):
        for frame in _frames(cfg, args, dev):
            # the min_update_rate watchdog (the reference arms it but never
            # binds its handler, src/ElevationMapping.cpp:1050-1057)
            now = time.time()
            if args.max_update_gap and now - last_t > args.max_update_gap:
                print(f"WARNING: {now - last_t:.2f}s since last frame "
                      f"(max_update_gap={args.max_update_gap}s)",
                      file=sys.stderr, flush=True)
            last_t = now
            if scan:
                batch.append(frame)
                if len(batch) == scan:
                    m = pipe.scan_steps(batch)
                    n += scan
                    batch = []
                    if args.metrics_out:
                        for t in range(scan):
                            metrics_log.log(n - scan + t + 1,
                                            {k: v[t] for k, v in m.items()})
                continue
            out = pipe.process(frame)
            n += 1
            if args.metrics_out:
                metrics_log.log(n, out.metrics)
            if args.log_every and n % args.log_every == 0:
                m = {k: _numpy(v).tolist() for k, v in out.metrics.items()}
                print(f"[{n}] {json.dumps(m)}", flush=True)
        for frame in batch:          # scan tail shorter than T: stepwise
            pipe.process(frame)
            n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    metrics_log.close()
    dt = time.time() - t0
    print(f"processed {n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.1f} Hz), "
          f"submaps={int(pipe.state.submaps.num_submaps)}")

    if args.keyframes or args.loop_demo:
        from gem_tpu_torch.global_map.loop_closure import apply_loop_closure

        if args.save_map:
            npts = _save_global_pcd(pipe, cfg,
                                    args.save_map + ".before_loop.pcd")
            print(f"pre-loop map ({npts} points) -> "
                  f"{args.save_map}.before_loop.pcd")
        if args.keyframes:
            rec = msgs.KeyframesRecord.load(args.keyframes)
            opt_poses = rec.poses
        else:
            # demo: simulate the SLAM optimiser correcting accumulated drift
            # (the ring may have wrapped: clamp to the stored slot count)
            s = pipe.state.submaps
            k = min(int(s.num_submaps), s.counts.shape[0])
            drift = np.linspace(0, 1, max(k, 1))[:, None] * \
                np.asarray([0.5, -0.3, 0.05, 0, 0, 0, 0], np.float32)
            opt_poses = _numpy(s.poses[:k]) + drift.astype(np.float32)
        new_submaps, stats = apply_loop_closure(pipe.state.submaps, cfg,
                                                opt_poses)
        pipe.state = pipe.state.replace(submaps=new_submaps)
        print(f"loop closure: {json.dumps(stats)}")

    if args.checkpoint:
        save_checkpoint(args.checkpoint, pipe.state)
        print(f"checkpoint -> {args.checkpoint}")

    if args.save_map:
        npts = _save_global_pcd(pipe, cfg, args.save_map)
        print(f"global map ({npts} points) -> {args.save_map}")

    traver = pipe.last_outputs.features.traver if pipe.last_outputs \
        else None
    if args.save_ortho:
        from gem_tpu_torch.render import orthomosaic

        image_mod.write_png(args.save_ortho, _numpy(
            orthomosaic(pipe.state.map, cfg.map, traver)))
        print(f"orthomosaic -> {args.save_ortho}")

    if args.save_heatmap:
        from gem_tpu_torch.render import elevation_heatmap

        image_mod.write_png(args.save_heatmap, _numpy(
            elevation_heatmap(pipe.state.map, cfg.map)))
        print(f"elevation heatmap -> {args.save_heatmap}")

    if args.save_costmap:
        if traver is None:
            traver = torch.full((cfg.map.length,) * 2, -10.0, device=dev)
        img, n_lethal = _costmap_png(traver, pipe.state.map.start, cfg, args)
        image_mod.write_png(args.save_costmap, img)
        print(f"costmap ({n_lethal} lethal cells) -> {args.save_costmap}")

    if args.save_octomap:
        from gem_tpu_torch.global_map.pyramid import build_pyramid

        cat = _global_cloud(pipe, cfg)
        origin, res, shape = octomap_grid(cat, cfg)
        t = {k: torch.from_numpy(cat[k]).to(dev)
             for k in ("x", "y", "z", "color", "traver", "valid")}
        road, obs = build_pyramid(
            t["x"], t["y"], t["z"], t["color"], t["traver"], t["valid"],
            origin=origin, base_resolution=res, shape=shape,
            travers_threshold=cfg.traversability_threshold)
        n_road = int(road[0].occupancy.sum())
        n_obs = int(obs[0].occupancy.sum())
        written = save_octomap(args.save_octomap, road, obs)
        for name, p, nn in written:
            if nn is not None:
                print(f"octomap {name} ({nn} nodes) -> {p}")
        print(f"voxel pyramid (road {n_road} / obstacle {n_obs} voxels) -> "
              f"{' + '.join(p for _, p, _ in written)}")

    s = state_to_numpy(pipe.state).submaps
    n_slots = min(int(s.num_submaps), s.counts.shape[0])
    if args.publish_submaps:
        os.makedirs(args.publish_submaps, exist_ok=True)
        for i in range(n_slots):
            rec = msgs.submap_record_from_store(s, i,
                                                robot_id=cfg.robot.robot_id)
            rec.save(os.path.join(args.publish_submaps, f"submap_{i}.npz"))
        print(f"{int(s.num_submaps)} submap records -> "
              f"{args.publish_submaps}/")

    if args.save_submaps:
        # savingSubMap (src/ElevationMapping.cpp:461-476); --dense applies
        # the MLS-equivalent surface upsample (denseMappingSignal parity)
        from gem_tpu_torch.global_map.densify import densify_submap
        from gem_tpu_torch.global_map.submaps import PointBuffer

        save_pcd = pcd.save_pcd
        os.makedirs(args.save_submaps, exist_ok=True)
        slots = pipe.state.submaps.slots
        for i in range(n_slots):
            path = os.path.join(args.save_submaps, f"{i}.pcd")
            if args.dense:
                buf = PointBuffer(**{f: getattr(slots, f)[i]
                                     for f in _FIELDS})
                d = {k: _numpy(v) for k, v in densify_submap(
                    buf, base_resolution=cfg.map.resolution, upsample=2,
                    grid_size=256, order=args.dense_order).items()}
                save_pcd(path, d["x"], d["y"], d["z"], d["color"],
                         np.zeros_like(d["z"]), d["variance"], d["traver"],
                         valid=d["valid"])
            else:
                save_pcd(path, s.slots.x[i], s.slots.y[i], s.slots.z[i],
                         s.slots.color[i], s.slots.intensity[i],
                         s.slots.variance[i], s.slots.traver[i],
                         valid=s.slots.valid[i])
        print(f"{int(s.num_submaps)} submaps"
              f"{' (densified)' if args.dense else ''} -> "
              f"{args.save_submaps}/")
    return 0


def octomap_grid(cat, cfg):
    """(origin, resolution, shape) of the octomap export's base level for a
    global cloud `cat`: centered on the map origin, spanning every valid
    point plus 2 m, capped at 512^2 x 128 voxels by coarsening the
    resolution so the pyramid always covers the whole map."""
    v = cat["valid"]
    span = max(float(np.abs(cat["x"][v]).max() if v.any() else 1.0),
               float(np.abs(cat["y"][v]).max() if v.any() else 1.0)) + 2.0
    dim = int(min(512, np.ceil(2 * span / cfg.map.resolution)))
    res = max(cfg.map.resolution, 2 * span / dim)
    return (-span, -span, -10.0), res, (dim, dim, 128)


def save_octomap(path, road, obs):
    """Write the road/obstacle pyramids: with a .bt / .ot extension two
    octomap files (`<stem>_road<ext>`, `<stem>_obstacle<ext>`, like the
    reference's road/obstacle octomap msgs, src/ElevationMapping.cpp:502-512;
    .ot = ColorOcTree, the reference's tree type, .bt = occupancy-only),
    else one npz of every level.  Returns [(name, path, octree node count,
    None for the npz)]."""
    if not path.endswith((".bt", ".ot")):
        out = {}
        for name, levels in (("road", road), ("obstacle", obs)):
            for i, g in enumerate(levels):
                out[f"{name}_l{i}_occ"] = _numpy(g.occupancy)
                out[f"{name}_l{i}_color"] = _numpy(g.color)
                out[f"{name}_l{i}_res"] = np.float32(g.resolution)
        out["origin"] = np.asarray(road[0].origin, np.float32)
        np.savez_compressed(path, **out)
        return [("levels", path, None)]
    ext, stem = path[-3:], path[:-3]
    written = []
    for name, g in (("road", road[0]), ("obstacle", obs[0])):
        p = f"{stem}_{name}{ext}"
        occ = _numpy(g.occupancy)
        if ext == ".bt":
            nn = octomap_io.write_voxelgrid_bt(p, occ, g.origin, g.resolution)
        else:
            idx = np.argwhere(occ)
            col = _numpy(g.color)[idx[:, 0], idx[:, 1], idx[:, 2]]
            center = lambda a: g.origin[a] + (idx[:, a] + 0.5) * g.resolution
            nn = octomap_io.write_ot(p, center(0), center(1), center(2), col,
                               g.resolution)
        written.append((name, p, nn))
    return written


def _drift_frame(frame, theta, txy):
    """Premultiply a frame's believed poses by a rigid SE(2) drift (yaw
    `theta`, translation `txy`): per-robot odometry drift for --loop-detect
    to recover.  The pose arithmetic is the JAX CLI's, in NumPy float32."""
    c, s = math.cos(theta), math.sin(theta)
    Rd = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    D = np.eye(4, dtype=np.float32)
    D[:3, :3] = Rd
    D[:2, 3] = txy
    qd = np.asarray([math.cos(theta / 2), 0, 0, math.sin(theta / 2)],
                    np.float32)
    q = _numpy(frame.pose_quat)
    qn = np.asarray([
        qd[0] * q[0] - qd[3] * q[3],
        qd[0] * q[1] - qd[3] * q[2],
        qd[0] * q[2] + qd[3] * q[1],
        qd[0] * q[3] + qd[3] * q[0]], np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        frame.transform.device)
    return dataclasses.replace(
        frame, transform=t(D @ _numpy(frame.transform)),
        r_map_base=t(Rd @ _numpy(frame.r_map_base)),
        t_map_base=t(Rd @ _numpy(frame.t_map_base) + D[:3, 3]),
        track_position=t(Rd @ _numpy(frame.track_position) + D[:3, 3]),
        pose_quat=t(qn))


def _fleet(args, dev, mode, group_world=1, group_rank=0):
    """Replay the fleet's synthetic drives through `fleet_step` on `dev`:
    all robots (vmap), or this rank's share of them (mesh, distributed)."""
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.multirobot import distributed as mdist
    from gem_tpu_torch.multirobot.fleet import FleetPipeline, stack_frames
    from gem_tpu_torch.utils.tree import tree_map

    cfg = _build_config(args)
    R = args.robots
    backend = "stream" if args.fuse_backend == "auto" else args.fuse_backend
    robots = mdist.local_robots(R)         # every robot without a group
    drift = (args.drift_yaw != 0.0 or args.drift_x != 0.0
             or args.drift_y != 0.0)
    # --world-seed >= 0 puts every robot in the same world with its own
    # heading (arcs that cross: the loop-detect scenario); otherwise every
    # robot drives its own world
    shared = args.world_seed >= 0
    gens = [synthetic_frames(
        cfg, args.frames, speed=args.speed,
        seed=args.world_seed if shared else r,
        heading=0.35 + (0.25 * r if shared else 0.0), device="cpu")
        for r in robots]
    fleet = FleetPipeline(cfg, len(robots), dev, backend)
    mdist.barrier("fleet_first_step")
    t0 = time.time()
    n, outs = 0, None
    for frames in zip(*gens):
        frame_list = [f for f, _, _ in frames]
        if drift:
            # as in the JAX CLI: robot 0 of the fleet keeps its pose, and in
            # the distributed mode every process's first robot
            first = robots[0] if mode == "distributed" else 0
            frame_list = [f if r == first else _drift_frame(
                f, math.radians(args.drift_yaw), (args.drift_x, args.drift_y))
                for r, f in zip(robots, frame_list)]
        stacked = tree_map(lambda x: x.to(dev), stack_frames(frame_list))
        outs = fleet.process(stacked)
        n += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    state = fleet.state
    pv = _numpy(outs.metrics["points_valid"]).tolist() if outs else []
    fused = _numpy((state.map.elevation != cfg.map.invalid_elevation)
                   .sum(dim=(-2, -1))).tolist()
    submaps = state.submaps
    if mode == "mesh" and group_world > 1:
        # rank 0 prints for the whole fleet, as JAX's one mesh process does:
        # every rank's counts, and its submap store for the loop detection
        store = (tree_map(lambda x: x.cpu(), submaps) if args.loop_detect
                 else None)
        gathered = [None] * group_world if group_rank == 0 else None
        torch.distributed.gather_object((fused, pv, store), gathered, dst=0)
        if group_rank:
            return 0
        fused = [v for g in gathered for v in g[0]]
        pv = [v for g in gathered for v in g[1]]
        if args.loop_detect:
            submaps = tree_map(lambda *xs: torch.cat(xs).to(dev),
                               *(g[2] for g in gathered))
    print(f"fleet of {R} robots: {n} frames in {dt:.2f}s "
          f"({n / max(dt, 1e-9):.1f} fleet-Hz, {mode})")
    print(f"per-robot fused cells: {fused}")
    print(f"per-robot last-frame valid points: {pv}")

    if args.loop_detect and mode != "distributed":
        # inter-robot loops from DiSCO signatures alone, the joint pose
        # graph and the re-stitch (the reference ships InterPR.msg to an
        # external MR_SLAM backend)
        from gem_tpu_torch.multirobot.loop_detect import fleet_loop_closure

        _, lstats, records = fleet_loop_closure(
            submaps, cfg, sim_threshold=args.loop_sim_threshold,
            center_gate=args.loop_center_gate)
        print("loop-detect:", json.dumps(lstats))
        if args.publish_interpr:
            os.makedirs(os.path.dirname(args.publish_interpr) or ".",
                        exist_ok=True)
            records.save(args.publish_interpr)
            print(f"{len(records.items)} InterPR records -> "
                  f"{args.publish_interpr}")
    elif args.loop_detect:
        print("loop-detect: skipped (single-host only)")
    return 0


def _fleet_rank(rank, args, coordinator, world, mode):
    """One process of a multi-process fleet: join the group, run this
    rank's robots, leave the group."""
    from gem_tpu_torch.multirobot import distributed as mdist

    dev = _device(args)
    mdist.initialize(coordinator, world, rank,
                     backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        dev = mdist.device()
        if mode == "distributed":
            print(f"process {rank}/{world}: "
                  f"{torch.distributed.get_backend()} on {dev}", flush=True)
        return _fleet(args, dev, mode, world, rank)
    finally:
        mdist.shutdown()


def cmd_fleet(args):
    """N-robot fleet replay.  Modes: `vmap` (every robot on one device, one
    process), `--mesh` (one process per visible card on this host, spawned
    here over a FileStore; one card: this process) and `--coordinator`
    (this process is rank --process-id of --num-processes, on any host).
    The mesh and distributed modes run the same code, each rank stepping
    its own robots with no collective.  A mesh prints from rank 0 for the
    whole fleet and detects loops there over every rank's submaps, as JAX's
    one mesh process does; the distributed mode prints each process's
    robots and detects no loops."""
    dev = _device(args)
    if args.coordinator:
        return _fleet_rank(args.process_id, args, args.coordinator,
                           args.num_processes, "distributed")
    if not args.mesh:
        return _fleet(args, dev, "vmap")
    # as JAX's mesh: min(devices, robots), which must divide the robots
    world = min(torch.cuda.device_count() if dev.type == "cuda" else 1,
                args.robots)
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        if world == 1:
            return _fleet_rank(0, args, store, 1, "mesh")
        torch.multiprocessing.spawn(_fleet_rank,
                                    args=(args, store, world, "mesh"),
                                    nprocs=world)
    return 0


def cmd_selftest(args):
    """Deployment health check: replay a short synthetic sequence through
    the production pipeline (`ElevationPipeline`, `stream`: K1 + K2 in a
    CUDA graph on a card) on --device, compare the final elevation plane
    with the segment backend on the CPU, and check the map is live.  Exit
    0 = healthy (the reference package's bounds: > 100 fused cells,
    validity agreement > 0.95, RMSE < 0.05 m)."""
    from gem_tpu_torch import config as C
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import (ElevationPipeline,
                                                frame_from_numpy)

    dev = _device(args)
    cfg = C.PipelineConfig(
        map=C.MapConfig(length=64, resolution=0.25, max_shift_cells=8),
        sensor=C.SensorConfig(model="laser"),
        body_filter=C.BodyFilterConfig(mode="none"),
        max_points=4096)
    frames = [f for f, _, _ in synthetic_frames(cfg, 6, n_points=4096,
                                                speed=0.4, seed=0,
                                                device="cpu")]
    planes = {}
    for name, where, backend in (("dev", dev, "stream"),
                                 ("cpu", torch.device("cpu"), "segment")):
        pipe = ElevationPipeline(cfg, device=where, fuse_backend=backend)
        for fr in frames:
            pipe.process(frame_from_numpy(fr, where))
        planes[name] = _numpy(pipe.state.map.elevation)
    e_dev, e_cpu = planes["dev"], planes["cpu"]
    inv = cfg.map.invalid_elevation
    fused = int((e_dev != inv).sum())
    both = (e_dev != inv) & (e_cpu != inv)
    agree = float(((e_dev != inv) == (e_cpu != inv)).mean())
    rmse = float(np.sqrt(np.mean((e_dev[both] - e_cpu[both]) ** 2))) \
        if both.any() else float("inf")
    ok = fused > 100 and agree > 0.95 and rmse < 0.05
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "device": f"{dev} ({name})", "fuse_backend": "stream",
        "fused_cells": fused, "validity_agreement": round(agree, 4),
        "rmse_vs_cpu_m": round(rmse, 6), "healthy": ok}))
    return 0 if ok else 1


def cmd_viz(args):
    """Render a PCD (global map / submap) to a top-down PNG, the
    replacement for the reference's rviz validation loop."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("viz needs matplotlib, which is not installed; "
                         "every other subcommand runs without it") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = pcd.load_pcd(args.pcd)
    x, y, z = d["x"], d["y"], d["z"]
    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    if args.color_by == "rgb" and "rgb" in d and (d["rgb"] != 0).any():
        rgb = d["rgb"].astype(np.uint32)
        c = np.stack([(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF],
                     -1) / 255.0
        axes[0].scatter(x, y, c=c, s=args.point_size)
        axes[0].set_title("color")
    else:
        sc = axes[0].scatter(x, y, c=z, cmap="turbo", s=args.point_size)
        fig.colorbar(sc, ax=axes[0], label="elevation [m]")
        axes[0].set_title("elevation")
    tr = d.get("travers", np.zeros_like(x))
    sc2 = axes[1].scatter(x, y, c=tr, cmap="RdYlGn", s=args.point_size,
                          vmin=0, vmax=1)
    fig.colorbar(sc2, ax=axes[1], label="traversability")
    axes[1].set_title("traversability")
    for ax in axes:
        ax.set_aspect("equal")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
    fig.suptitle(os.path.basename(args.pcd))
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    print(f"{len(x)} points -> {args.out}")
    return 0


def cmd_info(args):
    print("gem_tpu_torch info")
    print("  torch:", torch.__version__, "cuda:", torch.version.cuda)
    print("  cuda devices:", [torch.cuda.get_device_name(i)
                              for i in range(torch.cuda.device_count())])
    print("  config:", _build_config(args))
    return 0


def _parser() -> argparse.ArgumentParser:
    """The CLI's parser: every subcommand sets `fn`, its command."""
    from gem_tpu_torch.kernels.fuse import FUSE_BACKENDS

    ap = argparse.ArgumentParser(prog="gem_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="cuda: the CUDA kernels on the card (an error "
                            "without one); cpu: their plain PyTorch "
                            "versions")
        p.add_argument("--config", help="yaml config file")
        p.add_argument("--preset", default="kitti",
                       choices=["kitti", "yq", "benchmark", "default"])
        p.add_argument("--max-points", type=int, default=0)
        p.add_argument("--sensor",
                       help="sensor model preset (velodyne_vlp16, kinect, "
                            "realsense_d435, aslam_stereo, perfect, ...)")
        p.add_argument("--camera",
                       help="camera.npz (projection + image size) from the "
                            "KITTI converter, enables colorization")

    rp = sub.add_parser("run", help="replay a dataset through the pipeline")
    common(rp)
    rp.add_argument("--dataset", default="synthetic",
                    help="'synthetic' or a directory of per-frame .npz files")
    rp.add_argument("--frames", type=int, default=100)
    rp.add_argument("--speed", type=float, default=0.5)
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--fuse-backend", default="auto",
                    choices=("auto",) + FUSE_BACKENDS,
                    help="auto = stream")
    rp.add_argument("--scan", type=int, default=0, metavar="T",
                    help="replay T frames per scan_steps call")
    rp.add_argument("--log-every", type=int, default=0,
                    help="print metrics every N frames")
    rp.add_argument("--checkpoint", help="write final state npz")
    rp.add_argument("--resume", help="resume from a state npz")
    rp.add_argument("--save-map", help="write global cloud PCD")
    rp.add_argument("--save-submaps", help="write per-submap PCDs to dir")
    rp.add_argument("--dense", action="store_true",
                    help="densify submaps on export (MLS-equivalent "
                         "surface upsample; the dense_mapping signal)")
    rp.add_argument("--dense-order", type=int, default=2,
                    help="densify polynomial order 1..5 (the reference's "
                         "PCL MLS uses 5; 2 is exact on quadratic terrain "
                         "and stabler on thin support)")
    rp.add_argument("--save-ortho", help="write orthomosaic PNG")
    rp.add_argument("--save-heatmap", help="write elevation heatmap PNG")
    rp.add_argument("--save-costmap",
                    help="write inflated costmap PNG (InflationLayer "
                         "semantics)")
    rp.add_argument("--inflation-radius", type=float, default=0.55,
                    help="costmap inflation radius in meters")
    rp.add_argument("--cost-scaling", type=float, default=5.0,
                    help="InflationLayer cost_scaling_factor (1/m)")
    rp.add_argument("--save-octomap",
                    help="write the octomap export: road/obstacle voxel "
                         "pyramid npz, or, with a .bt / .ot extension, "
                         "binary octomap / ColorOcTree files")
    rp.add_argument("--publish-submaps",
                    help="write SubMapRecord npz files to dir")
    rp.add_argument("--keyframes",
                    help="KeyframesRecord npz with optimised poses; applies "
                         "the loop-closure re-stitch after replay")
    rp.add_argument("--loop-demo", action="store_true",
                    help="simulate a loop closure (drift-corrected poses) "
                         "and save before/after maps")
    rp.add_argument("--metrics-out",
                    help="JSONL metrics stream path (one record per frame)")
    rp.add_argument("--profile", help="torch.profiler trace directory")
    rp.add_argument("--max-update-gap", type=float, default=0.0,
                    help="warn when the inter-frame gap exceeds this many "
                         "seconds (the reference's min_update_rate watchdog)")
    rp.set_defaults(fn=cmd_run)

    fp = sub.add_parser("fleet", help="multi-robot replay: one process for "
                                      "the fleet, or one per card / host")
    common(fp)
    fp.add_argument("--robots", type=int, default=4)
    fp.add_argument("--frames", type=int, default=50)
    fp.add_argument("--speed", type=float, default=0.5)
    fp.add_argument("--fuse-backend", default="auto",
                    choices=("auto",) + FUSE_BACKENDS,
                    help="auto = stream")
    fp.add_argument("--mesh", action="store_true",
                    help="one process per visible card of this host, robots "
                         "split evenly (a FileStore process group)")
    fp.add_argument("--coordinator",
                    help="host:port of process 0 (or a shared file path): "
                         "join a multi-process fleet over torch.distributed "
                         "(run the same command in every process with its "
                         "own --process-id)")
    fp.add_argument("--num-processes", type=int, default=1)
    fp.add_argument("--process-id", type=int, default=0)
    fp.add_argument("--loop-detect", action="store_true",
                    help="after the replay, detect inter-robot loops from "
                         "DiSCO signatures, optimize the joint pose graph "
                         "and re-stitch (no external poses)")
    fp.add_argument("--loop-sim-threshold", type=float, default=0.93)
    fp.add_argument("--loop-center-gate", type=float, default=None,
                    help="candidate colocation gate in meters (default "
                         "0.4 * overlap_radius); odometry drift adds to "
                         "the believed keyframe distance, so widen this "
                         "when expecting more inter-robot drift")
    fp.add_argument("--world-seed", type=int, default=-1,
                    help=">=0: all robots share this world (per-robot "
                         "headings) so trajectories cross")
    fp.add_argument("--drift-yaw", type=float, default=0.0,
                    help="inject this odometry yaw drift (degrees) into "
                         "robots 1..N-1")
    fp.add_argument("--drift-x", type=float, default=0.0)
    fp.add_argument("--drift-y", type=float, default=0.0)
    fp.add_argument("--publish-interpr",
                    help="save detected loops as an InterPRs npz record")
    fp.set_defaults(fn=cmd_fleet)

    sp = sub.add_parser("selftest", help="health check: the production "
                                         "step on --device vs the segment "
                                         "backend on the CPU")
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sp.set_defaults(fn=cmd_selftest)

    vp = sub.add_parser("viz", help="render a PCD to a top-down PNG "
                                    "(needs matplotlib)")
    vp.add_argument("pcd")
    vp.add_argument("--out", default="map.png")
    vp.add_argument("--color-by", default="rgb", choices=["rgb", "elevation"])
    vp.add_argument("--point-size", type=float, default=2.0)
    vp.set_defaults(fn=cmd_viz)

    ip = sub.add_parser("info", help="environment + config dump")
    common(ip)
    ip.set_defaults(fn=cmd_info)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
