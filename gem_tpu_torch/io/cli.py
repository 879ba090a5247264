"""Command line interface: `python -m gem_tpu_torch <cmd>`.

Counterpart of gem_tpu/io/cli.py with the same flag names:

  gem_tpu_torch run    replay a dataset (synthetic | npz dir) through the
                       pipeline and write its map products
  gem_tpu_torch info   environment + config dump

`--device {cuda,cpu}` takes the place of `--platform`; `--device cuda`
without a card is an error, never a silent CPU run.  `--fuse-backend auto`
means `stream`.  The flags that need the rest of global_map/ (`--dense`,
`--save-octomap`, `--keyframes`, `--loop-demo`) fail before the first frame;
the `fleet`, `bench`, `selftest` and `viz` subcommands are not ported yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from gem_tpu_torch.shared import load as _load_shared

_FIELDS = ("x", "y", "z", "color", "intensity", "variance", "traver", "valid")
_UNPORTED = {
    "dense": "--dense needs global_map/densify",
    "save_octomap": "--save-octomap needs global_map/pyramid and octomap_io",
    "keyframes": "--keyframes needs global_map/loop_closure",
    "loop_demo": "--loop-demo needs global_map/loop_closure",
}


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
        catalog = _load_shared("sensors/catalog.py")
        cfg = cfg.replace(sensor=catalog.sensor_preset(args.sensor))
    if args.camera:
        d = np.load(args.camera)
        cfg = cfg.replace(camera=C.CameraConfig(
            image_height=int(d["image_height"]),
            image_width=int(d["image_width"]),
            projection=tuple(float(v) for v in d["projection"])))
    return cfg


def _device(args) -> torch.device:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run the plain PyTorch versions")
    return torch.device(args.device)


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
    pf = _load_shared("native/__init__.py").FramePrefetcher(paths, ring=4)
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
    native = _load_shared("native/__init__.py")
    cat = _global_cloud(pipe, cfg)
    # min-variance record per cell through the native spatial hash (the
    # reference dedups through its unordered_map on insert)
    kept = native.dedup_cells(cat["x"], cat["y"], cat["variance"],
                              cat["valid"], cfg.map.resolution)
    cat = {k: v[kept] for k, v in cat.items()}
    return _load_shared("io/pcd.py").save_pcd(
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
                                                scan_steps, state_to_numpy)
    from gem_tpu_torch.utils.observability import MetricsLogger, trace

    for flag, why in _UNPORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"{why}, which is not ported yet (ROADMAP.md "
                             f"Queue 1, global_map/*)")
    dev = _device(args)
    cfg = _build_config(args)
    backend = "stream" if args.fuse_backend == "auto" else args.fuse_backend
    pipe = ElevationPipeline(cfg, device=dev, fuse_backend=backend)
    if args.resume:
        pipe.state, _ = load_checkpoint(args.resume, cfg, device=dev)
        print(f"resumed from {args.resume} "
              f"(frame {int(pipe.state.frame_idx)})")

    image_mod = _load_shared("utils/image.py")
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
                    pipe.state, m = scan_steps(pipe.state, batch, cfg,
                                               backend)
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

    s = state_to_numpy(pipe.state).submaps
    n_slots = min(int(s.num_submaps), s.counts.shape[0])
    if args.publish_submaps:
        msgs = _load_shared("msgs.py")
        os.makedirs(args.publish_submaps, exist_ok=True)
        for i in range(n_slots):
            rec = msgs.submap_record_from_store(s, i,
                                                robot_id=cfg.robot.robot_id)
            rec.save(os.path.join(args.publish_submaps, f"submap_{i}.npz"))
        print(f"{int(s.num_submaps)} submap records -> "
              f"{args.publish_submaps}/")

    if args.save_submaps:
        # savingSubMap (src/ElevationMapping.cpp:461-476)
        save_pcd = _load_shared("io/pcd.py").save_pcd
        os.makedirs(args.save_submaps, exist_ok=True)
        for i in range(n_slots):
            save_pcd(os.path.join(args.save_submaps, f"{i}.pcd"),
                     s.slots.x[i], s.slots.y[i], s.slots.z[i],
                     s.slots.color[i], s.slots.intensity[i],
                     s.slots.variance[i], s.slots.traver[i],
                     valid=s.slots.valid[i])
        print(f"{int(s.num_submaps)} submaps -> {args.save_submaps}/")
    return 0


def cmd_info(args):
    print("gem_tpu_torch info")
    print("  torch:", torch.__version__, "cuda:", torch.version.cuda)
    print("  cuda devices:", [torch.cuda.get_device_name(i)
                              for i in range(torch.cuda.device_count())])
    print("  config:", _build_config(args))
    return 0


def main(argv=None):
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
                    choices=["auto", "stream", "segment", "sort", "pallas"],
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
                    help="densify submaps on export (not ported yet)")
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
                    help="write the octomap export (not ported yet)")
    rp.add_argument("--publish-submaps",
                    help="write SubMapRecord npz files to dir")
    rp.add_argument("--keyframes",
                    help="KeyframesRecord npz for the loop-closure re-stitch "
                         "(not ported yet)")
    rp.add_argument("--loop-demo", action="store_true",
                    help="simulate a loop closure (not ported yet)")
    rp.add_argument("--metrics-out",
                    help="JSONL metrics stream path (one record per frame)")
    rp.add_argument("--profile", help="torch.profiler trace directory")
    rp.add_argument("--max-update-gap", type=float, default=0.0,
                    help="warn when the inter-frame gap exceeds this many "
                         "seconds (the reference's min_update_rate watchdog)")
    rp.set_defaults(fn=cmd_run)

    ip = sub.add_parser("info", help="environment + config dump")
    common(ip)
    ip.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
