"""Drive the PyTorch port's mapping pipeline and CLI on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (times from CUDA events after a warm-up):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from gem_tpu_torch/csrc (one nvcc per source,
     in parallel);
  3. K1 (fuse_stream_aggregate) vs its plain PyTorch version on the card,
     at the L=1000 flagship: a 131072-point frame, a 1,048,576-point frame
     and a 131072-point frame with half its lanes colored;
  4. K2 (plane_fit_features) vs its plain version at L=1000;
  5. K3 (segment_stats_sorted) vs its plain version on the five column
     sets `fuse_pallas` reduces, on a 131072-point and a 1,048,576-point
     frame at L=1000;
  6. the fuse backends on one flagship frame: pallas, segment, sort and
     stream against each other, and the `lowest` plane;
  7. the step on the card vs the same step on the CPU (plain versions),
     L=256, 10 frames, with the stream and the pallas backend;
  8. the flagship: L=1000, 131072-point frames, raytrace every frame, 30
     frames at 0.5 m/frame, with launch counters, shed, keyframe and
     accuracy checks: the stream path (K1, K2), then the pallas path (K3,
     K2);
  9. the CLI in-process: `run` at the benchmark preset with the pallas
     backend and every product, a resume from its checkpoint (with the
     .bt octomap export), and the kitti preset (orthomosaics stored, the
     npz pyramid) with the segment backend; then the global-map path,
     `run --loop-demo --save-octomap x.ot --dense --save-submaps` with the
     stream backend (K1 and K2 launches counted from 0), and `selftest`;
 10. the global map at the flagship's own ring (64 slots x 32768 points):
     a loop-closure re-stitch, densify at orders 2 and 5 on one slot, the
     (512, 512, 128) voxel pyramid of phase 8's global cloud with its .bt
     and .ot files, and the DiSCO signatures of all 64 slots, each on the
     card and on the CPU from the same inputs, with both times.
Then one JSON line of per-kernel results, the nvidia-smi line again, and
the last line {"ok": true, "device": {...}}.  Any failure raises: the
script exits non-zero and prints no result.  It imports no jax.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def fail_unless(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rows_compare(a, b):
    """Check K1's 16 rows against the plain version's.  Every row but the
    two gated sums is a selection and must agree bitwise; W and WH are f32
    sums of each cell's run, which the plain version adds with atomics in
    no fixed order, so W is held to 1e-5 relative and the height estimate
    WH/W to 5e-5 m (a few hundred terms, |h| of a few metres).  Returns
    (W's max relative error, WH/W's max absolute error)."""
    exact = [k for k in range(16) if k not in (4, 5)]
    fail_unless(bool((a[exact] == b[exact]).all()),
                "K1: selection rows differ from the plain version")
    has = b[4] > 0
    fail_unless(bool(((a[4] > 0) == has).all()), "K1: inlier sets differ")
    rel_w = float(((a[4] - b[4]).abs() / b[4])[has].max())
    h_err = float((a[5] / a[4] - b[5] / b[4])[has].abs().max())
    fail_unless(rel_w <= 1e-5 and h_err <= 5e-5,
                f"K1: gated sums differ (W {rel_w}, WH/W {h_err})")
    return rel_w, h_err


def frame_batch(state, frame, cfg):
    """The step's own stages up to the fuse: move, then point processing.
    Returns (moved map, point batch, pointproc's `lowest` plane)."""
    from gem_tpu_torch.core.move import move
    from gem_tpu_torch.kernels.pointproc import process_points
    from gem_tpu_torch.sensors.models import jacobian_ingredients

    ms, _ = move(state.map, cfg.map, frame.track_position)
    jac = jacobian_ingredients(frame.r_map_base, frame.r_base_sensor,
                               frame.t_base_sensor)
    batch, lowest = process_points(
        ms, cfg, frame.points, frame.intensity, frame.valid, frame.transform,
        frame.t_map_base[2], jac[0], frame.pose_cov[3:, 3:], *jac[1:],
        colors=frame.colors)
    return ms, batch, lowest


def phase_k1(cfg_fn, dev):
    """K1 vs plain on three flagship frames; returns (kernel line, map)."""
    import dataclasses

    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.kernels import fuse_stream as fs
    from gem_tpu_torch.mapping.pipeline import init_pipeline_state, step

    results = []
    prior = None
    cases = [("131k", 1 << 17, False), ("1M", 1 << 20, False),
             ("131k_colored", 1 << 17, True)]
    for name, n, colored in cases:
        cfg = cfg_fn(max_points=n)
        frames = [f for f, _, _ in synthetic_frames(
            cfg, 3, n_points=n, speed=0.5, seed=1, device=dev)]
        state = init_pipeline_state(cfg, dev)
        for f in frames[:2]:                 # a populated prior to fuse into
            state, _ = step(state, f, cfg)
        frame = frames[2]
        if colored:
            # half the lanes colored (rows 12-14), and 2% lifted by 1 m so
            # colored start rows are outliers of the prior (rows 7-10)
            rng = np.random.default_rng(5)
            P = frame.points.shape[0]
            col = np.where(rng.random(P) < 0.5,
                           rng.integers(1, 1 << 24, P), 0).astype(np.int32)
            lift = torch.from_numpy(
                (rng.random(P) < 0.02).astype(np.float32)).to(dev)
            pts = frame.points.clone()
            pts[:, 2] += lift
            frame = dataclasses.replace(
                frame, points=pts, colors=torch.from_numpy(col).to(dev))
        ms, batch, _ = frame_batch(state, frame, cfg)
        L = cfg.map.length
        args = (*fs.sort_points(batch, L * L), ms.elevation.reshape(-1),
                ms.variance.reshape(-1), cfg.map)
        k = fs.fuse_stream_aggregate(*args)
        p = fs.fuse_stream_aggregate_plain(*args)
        torch.cuda.synchronize()
        rel_w, h_err = rows_compare(k, p)
        if colored:
            fail_unless(int((k[12] < float("inf")).sum())
                        > 0.25 * int((k[2] > 0).sum()),
                        "K1 colored case: too few colored inlier cells")
            fail_unless(int((k[7] > 0).sum()) > 0,
                        "K1 colored case: no colored outlier start row")
        # the fused planes through the dense posterior: kernel vs plain
        fused_k = fs.apply_aggregates(ms, cfg, k)
        fused_p = fs.apply_aggregates(ms, cfg, p)
        plane_err = 0.0
        for key in ("elevation", "variance", "lowest", "intensity"):
            d = (getattr(fused_k, key) - getattr(fused_p, key)).abs().max()
            plane_err = max(plane_err, float(d))
        # elevation/variance: Kalman posterior of the W/WH sums above, f32
        # sums of up to a few hundred terms in another order: 5e-5
        fail_unless(plane_err <= 5e-5, f"K1 {name}: planes differ "
                    f"by {plane_err}")
        fail_unless(bool(torch.equal(fused_k.color, fused_p.color)),
                    f"K1 {name}: color planes differ")
        t_k = cuda_ms(lambda: fs.fuse_stream_aggregate(*args), 20)
        t_p = cuda_ms(lambda: fs.fuse_stream_aggregate_plain(*args), 20)
        print(f"phase 3 K1 {name}: ok points={int(batch.valid.sum())} "
              f"cells={int((k[2] > 0).sum())} selection_rows=bitwise "
              f"W_max_rel_err={rel_w:.3g} H_max_abs_err={h_err:.3g} "
              f"planes_max_abs_err={plane_err:.3g} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f}", flush=True)
        results.append((name, plane_err, t_k, t_p))
        if name == "131k":
            prior = fused_k
    return results, prior


def phase_k2(cfg, state_map, dev):
    from gem_tpu_torch.kernels import features as ft

    k = ft.plane_fit_features(state_map, cfg.map)
    p = ft.compute_features(state_map, cfg.map)
    torch.cuda.synchronize()
    fail_unless(bool(torch.equal(k.neighbor_count, p.neighbor_count)),
                "K2: neighbor counts differ")
    flat = p.normal_z > 1.0 - 1e-6
    err = 0.0
    for key in ("slope", "rough", "traver", "normal_z"):
        d = (getattr(k, key) - getattr(p, key)).abs()
        # 1e-5 everywhere (the JAX suite's pallas-vs-XLA bound); slope and
        # traver 1e-3 where normal_z > 1 - 1e-6, since d acos/dx is
        # unbounded at 1 and one ULP of normal_z there is ~3e-4 rad
        if key in ("slope", "traver"):
            fail_unless(bool((d[flat] <= 1e-3).all()),
                        f"K2 {key}: near-flat cells differ by "
                        f"{float(d[flat].max())}")
            d = d[~flat]
        m = float(d.max()) if d.numel() else 0.0
        fail_unless(m <= 1e-5, f"K2 {key}: differs by {m}")
        err = max(err, m)
    valid = int((k.traver != cfg.map.invalid_traversability).sum())
    fused = int((state_map.elevation != cfg.map.invalid_elevation).sum())
    fail_unless(valid > 0.25 * fused,
                f"K2: only {valid} of {fused} fused cells classified")
    t_k = cuda_ms(lambda: ft.plane_fit_features(state_map, cfg.map), 50)
    t_p = cuda_ms(lambda: ft.compute_features(state_map, cfg.map), 10)
    print(f"phase 4 K2 L={cfg.map.length}: ok classified={valid} "
          f"max_abs_err={err:.3g} kernel_ms={t_k:.4f} plain_ms={t_p:.4f}",
          flush=True)
    return err, t_k, t_p


def phase_parity(dev, backend):
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline

    cfg = benchmark_config(length=256, max_points=16384)
    gpu = ElevationPipeline(cfg, device=dev, fuse_backend=backend)
    cpu = ElevationPipeline(cfg, device="cpu", fuse_backend=backend)
    t0 = time.perf_counter()
    for f, _, _ in synthetic_frames(cfg, 10, n_points=16384, speed=0.5,
                                    seed=3, device="cpu"):
        cpu.process(f)
        gpu.process(type(f)(**{k: None if v is None else v.to(dev)
                               for k, v in vars(f).items()}))
    torch.cuda.synchronize()
    a, b = gpu.state.map, cpu.state.map
    g = lambda t: t.detach().cpu()
    inv = cfg.map.invalid_elevation
    occ_a, occ_b = g(a.elevation) != inv, g(b.elevation) != inv
    agree = float((occ_a == occ_b).float().mean())
    both = occ_a & occ_b
    errs = {}
    for key in ("elevation", "variance", "intensity"):
        errs[key] = float((g(getattr(a, key)) - g(getattr(b, key)))[both]
                          .abs().max())
    cls = both & (g(a.traver) != cfg.map.invalid_traversability) \
        & (g(b.traver) != cfg.map.invalid_traversability)
    errs["traver"] = float((g(a.traver) - g(b.traver))[cls].abs().max())
    errs["lowest"] = float((g(a.lowest) - g(b.lowest)).abs().max())
    # same sort, same sequential per-cell sums: occupancy may differ only
    # where an acos ULP flips a raytrace obstacle test (traver vs 0.7)
    fail_unless(agree >= 0.999, f"parity: occupancy agreement {agree}")
    fail_unless(int(both.sum()) > 0.1 * cfg.map.length ** 2,
                "parity: too few fused cells")
    fail_unless(errs["elevation"] <= 1e-4 and errs["variance"] <= 1e-4,
                f"parity: planes differ {errs}")
    fail_unless(errs["traver"] <= 1e-3, f"parity: traver differs {errs}")
    fail_unless(errs["lowest"] <= 1e-5 and errs["intensity"] == 0.0,
                f"parity: lowest/intensity differ {errs}")
    fail_unless(bool(torch.equal(g(a.color)[both], g(b.color)[both])),
                "parity: color differs")
    fail_unless(bool(torch.equal(g(a.start), g(b.start))
                     and torch.equal(g(a.center), g(b.center))),
                "parity: window differs")
    fail_unless(int(gpu.state.submaps.accum_count)
                == int(cpu.state.submaps.accum_count)
                and int(gpu.state.submaps.num_submaps)
                == int(cpu.state.submaps.num_submaps),
                "parity: submap counts differ")
    print(f"phase 7 parity {backend} L=256 gpu-vs-cpu 10 frames: ok "
          f"occupancy_agree="
          f"{agree:.6f} fused={int(both.sum())} max_abs_err={errs} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def fuse_pallas_calls(ms, cfg, batch):
    """The argument tuples of the five `segment_stats_sorted` calls that
    one `fuse_pallas` makes on this frame, recorded around the real call."""
    from gem_tpu_torch.kernels import fuse as fz

    calls = []
    real = fz.segment_stats_sorted

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    fz.segment_stats_sorted = record
    try:
        fz.fuse_pallas(ms, cfg, batch)
    finally:
        fz.segment_stats_sorted = real
    fail_unless(len(calls) == 5, f"fuse_pallas made {len(calls)} calls")
    return calls


def k3_compare(args):
    """K3 against its plain version on one call's arguments: mins and maxs
    bitwise, each sum within 1e-5 of the sum of its terms' magnitudes (the
    plain version adds with atomics in no fixed order).  Returns the max
    abs error of the sums."""
    from gem_tpu_torch.kernels import segment_stats as sst

    ids_s, sv, mv, xv, S = args
    ks, kn, kx, _ = sst.segment_stats_sorted(*args)
    ps, pn, px = sst.segment_stats_sorted_plain(*args)
    mag = sst.segment_stats_sorted_plain(ids_s, sv.abs(), mv, xv, S)[0]
    torch.cuda.synchronize()
    fail_unless(bool(torch.equal(kn, pn) and torch.equal(kx, px)),
                "K3: mins/maxs differ from the plain version")
    d = (ks - ps).abs()
    fail_unless(bool((d <= 1e-5 * mag).all()),
                f"K3: sums differ by up to {float(d.max())}")
    return float(d.max())


def phase_k3(cfg_fn, dev):
    """K3 vs plain on the five column sets of fuse_pallas, on the third
    frame of a 131072-point and of a 1,048,576-point drive (two warm frames
    through the pallas step first).  Returns (results, the 131k frame's
    (cfg, moved map, batch, lowest))."""
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.kernels import segment_stats as sst
    from gem_tpu_torch.mapping.pipeline import init_pipeline_state, step

    results, flagship = [], None
    for name, n in (("131k", 1 << 17), ("1M", 1 << 20)):
        cfg = cfg_fn(max_points=n)
        frames = [f for f, _, _ in synthetic_frames(
            cfg, 3, n_points=n, speed=0.5, seed=1, device=dev)]
        state = init_pipeline_state(cfg, dev)
        for f in frames[:2]:
            state, _ = step(state, f, cfg, fuse_backend="pallas")
        ms, batch, lowest = frame_batch(state, frames[2], cfg)
        calls = fuse_pallas_calls(ms, cfg, batch)
        err = max(k3_compare(a) for a in calls)
        # the wrapper as fuse_pallas calls it: offsets search + kernel
        t_k = sum(cuda_ms(lambda: sst.segment_stats_sorted(
            *a, with_spill=False), 20) for a in calls)
        t_p = sum(cuda_ms(lambda: sst.segment_stats_sorted_plain(*a), 20)
                  for a in calls)
        print(f"phase 5 K3 {name}: ok points={int(batch.valid.sum())} "
              f"calls=5 F={[tuple(x.shape[0] for x in a[1:4]) for a in calls]}"
              f" mins_maxs=bitwise sums_max_abs_err={err:.3g} "
              f"kernel_ms_per_call={t_k / 5:.4f} plain_ms_per_call="
              f"{t_p / 5:.4f} kernel_ms_per_frame={t_k:.4f} "
              f"plain_ms_per_frame={t_p:.4f}", flush=True)
        results.append((name, err, t_k / 5, t_p / 5))
        if name == "131k":
            flagship = (cfg, ms, batch, lowest)
    return results, flagship


def phase_backends(cfg, ms, batch, lowest):
    """The four fuse backends on one flagship frame.  pallas vs segment:
    the JAX suite's bounds (tests/test_fuse.py, rtol 3e-5 / atol 1e-5);
    stream vs segment: 5e-5 (phase 3's bound: per-cell f32 sums in another
    order); sort vs segment: 0.05 m and 2% of the variance, since its sums
    are a global f32 cumsum minus the carry at each run start and the
    prefix of 1/v over 131072 points reaches ~1e8 (an ULP of 8); colors
    equal everywhere; pointproc's `lowest` bitwise the stream fuse's."""
    from gem_tpu_torch.kernels.fuse import fuse
    from gem_tpu_torch.kernels.fuse_stream import fuse_stream

    base = ms.replace(lowest=lowest)
    out = {b: fuse(base, cfg, batch, backend=b)
           for b in ("segment", "sort", "pallas")}
    out["stream"] = fuse_stream(ms, cfg, batch)
    torch.cuda.synchronize()
    seg = out["segment"]
    errs = {}
    for b in ("pallas", "stream", "sort"):
        o = out[b]
        fail_unless(bool(torch.equal(o.color, seg.color)),
                    f"backends: {b} color differs from segment")
        e = {k: float((getattr(o, k) - getattr(seg, k)).abs().max())
             for k in ("elevation", "variance", "intensity")}
        errs[b] = e
        if b == "pallas":
            for k in e:
                a, r = getattr(o, k), getattr(seg, k)
                fail_unless(bool(torch.allclose(a, r, rtol=3e-5, atol=1e-5)),
                            f"backends: pallas {k} vs segment {e}")
        elif b == "stream":
            fail_unless(max(e.values()) <= 5e-5,
                        f"backends: stream vs segment {e}")
        else:
            rel_v = float(((o.variance - seg.variance).abs()
                           / seg.variance.abs()).max())
            errs[b]["variance_rel"] = rel_v
            fail_unless(e["elevation"] <= 0.05 and rel_v <= 0.02
                        and e["intensity"] == 0.0,
                        f"backends: sort vs segment {errs[b]}")
    fail_unless(bool(torch.equal(lowest, out["stream"].lowest)),
                "backends: pointproc lowest differs from the stream fuse's")
    inv = cfg.map.invalid_elevation
    fused = int((seg.elevation != inv).sum())
    fail_unless(fused > 0.05 * cfg.map.length ** 2,
                f"backends: only {fused} cells fused")
    print(f"phase 6 backends L={cfg.map.length} P={batch.valid.numel()}: "
          f"ok fused={fused} "
          f"max_abs_vs_segment={errs} lowest=bitwise", flush=True)


def png_shape(path):
    with open(path, "rb") as f:
        head = f.read(24)
    fail_unless(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                                "big")
    return h, w, 3


def pcd_points(path):
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"POINTS"):
                return int(line.split()[1])
    raise AssertionError(f"{path}: no POINTS line")


def phase_cli(dev):
    """`python -m gem_tpu_torch run` in-process on the card, into a
    temporary directory."""
    from gem_tpu_torch.config import benchmark_config, kitti_config
    from gem_tpu_torch.io.cli import main as cli

    L, Lk = benchmark_config().map.length, kitti_config().map.length
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)
        bench = ["run", "--device", dev.type, "--preset", "benchmark",
                 "--fuse-backend", "pallas"]
        fail_unless(cli([*bench, "--frames", "30", "--save-map", p("map.pcd"),
                         "--save-ortho", p("ortho.png"), "--save-heatmap",
                         p("heat.png"), "--save-costmap", p("cost.png"),
                         "--checkpoint", p("ck.npz"), "--metrics-out",
                         p("m.jsonl")]) == 0, "cli: benchmark run failed")
        for name in ("ortho.png", "heat.png", "cost.png"):
            fail_unless(png_shape(p(name)) == (L, L, 3),
                        f"cli: {name} is {png_shape(p(name))}")
        n_map = pcd_points(p("map.pcd"))
        fail_unless(n_map > 0.001 * L * L,
                    f"cli: map.pcd holds {n_map} points")
        with open(p("m.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        fail_unless(len(rows) == 30 and rows[-1]["cells_fused"] > 0,
                    "cli: metrics stream")
        fail_unless(cli([*bench, "--frames", "5", "--resume", p("ck.npz"),
                         "--checkpoint", p("ck2.npz"), "--save-octomap",
                         p("x.bt")]) == 0, "cli: resume failed")
        bt_leaves = octree_leaves(p("x_road.bt")) \
            + octree_leaves(p("x_obstacle.bt"))
        fail_unless(bt_leaves > 0, "cli: empty .bt octomaps")
        idx = (int(np.load(p("ck.npz"))["frame_idx"]),
               int(np.load(p("ck2.npz"))["frame_idx"]))
        fail_unless(idx == (30, 35), f"cli: frame_idx {idx} != (30, 35)")
        fail_unless(cli(["run", "--device", dev.type, "--preset", "kitti",
                         "--fuse-backend", "segment", "--frames", "30",
                         "--publish-submaps", p("records"), "--save-octomap",
                         p("x.npz")]) == 0, "cli: kitti run failed")
        levels = np.load(p("x.npz"))
        fail_unless(levels["road_l0_occ"].shape[2] == 128
                    and levels["road_l0_occ"].any()
                    and levels["obstacle_l2_occ"].shape[2] == 32,
                    "cli: npz pyramid")
        recs = sorted(os.listdir(p("records")))
        fail_unless(len(recs) >= 1, "cli: no submap record")
        rec = np.load(os.path.join(p("records"), recs[0]))
        ortho = rec["ortho_image"]
        fail_unless(ortho.shape == (Lk, Lk, 3) and ortho.dtype == np.uint8
                    and rec["points"].shape[0] > 0,
                    f"cli: record ortho {ortho.shape} {ortho.dtype}")
    print(f"phase 9 cli: ok benchmark/pallas 30 frames map_points={n_map} "
          f"pngs={L}x{L}x3 resumed_frame_idx={idx[1]} bt_leaves={bt_leaves} "
          f"kitti/segment records={len(recs)} ortho={ortho.shape} "
          f"npz_levels={len(levels.files)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def octree_leaves(path):
    """Occupied leaves of a .bt or .ot file, read back by the shared reader."""
    from gem_tpu_torch.shared import load

    octo = load("global_map/octomap_io.py")
    read = octo.read_bt if path.endswith(".bt") else octo.read_ot
    return len(read(path)[1])


def run_cli(argv):
    """`python -m gem_tpu_torch <argv>` in-process: (exit code, stdout)."""
    from gem_tpu_torch.io.cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    return rc, buf.getvalue()


def phase_global_map_cli(dev):
    """This slice's path through the CLI on the card: 40 kitti-preset frames
    at 1 m/frame (three submaps) with the stream backend, every launch count
    set to 0 just before and read just after; the loop-demo re-stitch, the
    .ot octomap export and densified submaps; then `selftest`.  (The kitti
    preset, because a densified submap is a 12.8 m grid anchored at its
    slot's minimum x and y, which the benchmark preset's 100 m window
    leaves empty.)"""
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        rc, out = run_cli(["run", "--device", dev.type, "--preset",
                           "kitti", "--frames", "40", "--speed", "1.0",
                           "--loop-demo", "--save-map", p("map.pcd"),
                           "--save-octomap", p("x.ot"), "--dense",
                           "--save-submaps", p("subs")])
        launches = {k: w.launches for k, w in wrappers.items()}
        fail_unless(rc == 0, "global-map cli: run failed")
        fail_unless(launches == {"fuse_stream_aggregate": 40,
                                 "plane_fit_features": 40,
                                 "segment_stats_sorted": 0},
                    f"global-map cli: launch counts {launches}")
        stats = json.loads(out.split("loop closure: ")[1].splitlines()[0])
        fail_unless(stats["n_corrected"] >= 2 and stats["n_pairs"] > 0
                    and stats["n_cells_fused"] > 0,
                    f"global-map cli: loop closure {stats}")
        n_road, n_obs = (int(v) for v in re.search(
            r"road (\d+) / obstacle (\d+) voxels", out).groups())
        leaves = (octree_leaves(p("x_road.ot")),
                  octree_leaves(p("x_obstacle.ot")))
        fail_unless(leaves == (n_road, n_obs) and n_road > 0,
                    f"global-map cli: .ot leaves {leaves} vs voxels "
                    f"{(n_road, n_obs)}")
        n_before = pcd_points(p("map.pcd.before_loop.pcd"))
        n_after = pcd_points(p("map.pcd"))
        dense_pts = [pcd_points(os.path.join(p("subs"), f))
                     for f in sorted(os.listdir(p("subs")))]
        fail_unless(n_before > 0 and n_after > 0 and len(dense_pts) == 3
                    and min(dense_pts) > 5000,
                    f"global-map cli: maps {n_before}/{n_after}, dense "
                    f"submaps of {dense_pts} points")
        rc, out = run_cli(["selftest", "--device", dev.type])
        rep = json.loads(out.strip().splitlines()[-1])
        fail_unless(rc == 0 and rep["healthy"], f"selftest: {rep}")
    print(f"phase 9 global-map cli kitti/stream 40 frames: ok "
          f"launches={launches} "
          f"loop_closure={json.dumps(stats)} octomap_ot_leaves={leaves} "
          f"map_points_before/after={n_before}/{n_after} "
          f"dense_submap_points={dense_pts} "
          f"selftest={json.dumps(rep)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def terrain(x, y):
    """The seeded world of phase 10: smooth relief, analytic."""
    return (0.5 * np.sin(x / 7.0) + 0.4 * np.cos(y / 9.0)
            + 0.05 * np.sin((x + y) / 3.0))


def global_map_store(cfg, device):
    """The flagship ring filled through finalize_submap: 64 slots whose
    centers lie on a 60 m loop (radius ~9.5 m, so every center is inside
    every other's 25 m overlap radius and the cap of 8 pairs per submap
    binds), each holding a 181 x 181-cell patch (32761 of 32768 points) at
    cell centers around its center, z = terrain + 0.01 * slot, variance in
    (0, 1).  Returns (store, poses)."""
    from gem_tpu_torch.global_map import submaps as sm

    K, C = cfg.submap.max_submaps, cfg.submap.capacity
    res = cfg.map.resolution
    rng = np.random.default_rng(0)
    store = sm.init_store(cfg, device)
    poses = np.zeros((K, 7), np.float32)
    poses[:, 3] = 1.0
    n = int(np.sqrt(C))
    for k in range(K):
        a = 2 * np.pi * k / K
        cx, cy = 60 / (2 * np.pi) * np.cos(a), 60 / (2 * np.pi) * np.sin(a)
        poses[k, :2] = cx, cy
        gx, gy = np.meshgrid(np.round(cx / res) + np.arange(n) - n // 2,
                             np.round(cy / res) + np.arange(n) - n // 2,
                             indexing="ij")
        x = np.zeros(C, np.float32)
        y = np.zeros(C, np.float32)
        x[:n * n] = ((gx.reshape(-1) + 0.5) * res).astype(np.float32)
        y[:n * n] = ((gy.reshape(-1) + 0.5) * res).astype(np.float32)
        f = {"x": x, "y": y,
             "z": (terrain(x, y) + 0.01 * k).astype(np.float32),
             "variance": rng.uniform(0.01, 0.99, C).astype(np.float32),
             "intensity": rng.random(C).astype(np.float32),
             "traver": rng.random(C).astype(np.float32),
             "color": rng.integers(0, 1 << 24, C).astype(np.int32),
             "valid": np.arange(C) < n * n}
        buf = sm.PointBuffer(**{key: torch.from_numpy(v).to(device)
                                for key, v in f.items()})
        store = sm.finalize_submap(store, buf,
                                   torch.from_numpy(poses[k]).to(device))
    return store, poses


def timed(fn, sync):
    """(result, milliseconds) of one call of fn, ending in a sync."""
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_global_map(dev, cloud):
    """Phase 10: the global-map modules at the flagship's own ring, each on
    the card and on the CPU (the plain PyTorch path) from the same
    inputs."""
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.global_map.densify import densify_submap
    from gem_tpu_torch.global_map.loop_closure import apply_loop_closure
    from gem_tpu_torch.global_map.place_recognition import (disco_signature,
                                                            match_signatures,
                                                            polar_bev)
    from gem_tpu_torch.global_map.pyramid import build_pyramid
    from gem_tpu_torch.global_map.submaps import PointBuffer
    from gem_tpu_torch.io.cli import octomap_grid, save_octomap

    cfg = benchmark_config()
    K, C = cfg.submap.max_submaps, cfg.submap.capacity
    res = cfg.map.resolution
    where = {"card": dev, "cpu": torch.device("cpu")}
    sync = dev.type == "cuda"

    def on_both(fn):
        """{side: (fn(side), ms)}: the card's call after one warm-up."""
        fn("card")
        if sync:
            torch.cuda.synchronize()
        return {side: timed(lambda: fn(side), sync and side == "card")
                for side in where}

    def slot(store, k):
        return PointBuffer(**{f: getattr(store.slots, f)[k] for f in (
            "x", "y", "z", "variance", "intensity", "traver", "color",
            "valid")})

    stores = {}
    for side, d in where.items():
        stores[side], poses = global_map_store(cfg, d)
    # drift-corrected poses: every keyframe but the anchor moves by whole
    # cells, so every point stays at a cell center
    rng = np.random.default_rng(1)
    opt = poses.copy()
    opt[1:, :2] += res * rng.integers(-3, 4, (K - 1, 2))

    # --- loop-closure event
    lc = on_both(lambda side: apply_loop_closure(stores[side], cfg, opt))
    (new_d, st_d), lc_ms = lc["card"]
    (new_c, st_c), lc_cpu_ms = lc["cpu"]
    fail_unless(st_d == st_c, f"global map: loop stats {st_d} vs {st_c}")
    fail_unless(st_d["n_corrected"] == K and st_d["n_pairs"] == 8 * K
                and st_d["n_cells_fused"] > K * C // 10,
                f"global map: loop stats {st_d}")
    lc_err = {key: float((getattr(new_d.slots, key).cpu()
                          - getattr(new_c.slots, key)).abs().max())
              for key in ("x", "y", "z", "variance")}
    fail_unless(lc_err["x"] == 0.0 and lc_err["y"] == 0.0
                and lc_err["z"] <= 1e-5 and lc_err["variance"] <= 1e-5,
                f"global map: loop closure card vs cpu {lc_err}")

    # --- densify slot 0 (G = 256): the CLI's call at orders 2 and 5, card
    # vs CPU; then order 5 at the points' own spacing, held to the analytic
    # terrain on interior cells (the JAX suite's 3e-4 m bound)
    dens = {}
    for order in (2, 5):
        kw = dict(base_resolution=res, upsample=2, grid_size=256, order=order)
        out = on_both(lambda side: densify_submap(slot(stores[side], 0), **kw))
        (dd, t_d), (dc, t_c) = out["card"], out["cpu"]
        v = dc["valid"]
        fail_unless(bool(torch.equal(dd["valid"].cpu(), v))
                    and int(v.sum()) > 10000,
                    f"densify order {order}: valid masks differ")
        zd = dd["z"].cpu()[v]
        dz = float((zd - dc["z"][v]).abs().max())
        fail_unless(dz <= 1e-4 and bool(torch.isfinite(zd).all()),
                    f"densify order {order}: card vs cpu z {dz}")
        dens[order] = (dz, t_d, t_c, int(v.sum()))
    s0 = slot(stores["cpu"], 0)
    origin5 = (float(s0.x[s0.valid].min()) - res / 2,
               float(s0.y[s0.valid].min()) - res / 2)
    n = int(np.sqrt(C))
    fit_err = {}
    for side in where:
        o = densify_submap(slot(stores[side], 0), base_resolution=res,
                           upsample=1, grid_size=256, origin=origin5,
                           order=5)
        zz = o["z"].cpu().numpy().reshape(256, 256)
        truth = terrain(o["x"].cpu().numpy(),
                        o["y"].cpu().numpy()).reshape(256, 256)
        fit_err[side] = float(np.abs(zz - truth)[3:n - 3, 3:n - 3].max())
    fail_unless(max(fit_err.values()) < 3e-4,
                f"densify order 5 vs the analytic terrain {fit_err}")

    # --- voxel pyramid + octomap files of phase 8's global cloud
    origin, vres, shape = octomap_grid(cloud, cfg)
    fail_unless(shape == (512, 512, 128), f"pyramid: grid {shape}")
    pts = {side: {k: torch.from_numpy(cloud[k]).to(d)
                  for k in ("x", "y", "z", "color", "traver", "valid")}
           for side, d in where.items()}
    pyr = on_both(lambda side: build_pyramid(
        *(pts[side][k] for k in ("x", "y", "z", "color", "traver", "valid")),
        origin=origin, base_resolution=vres, shape=shape,
        travers_threshold=cfg.traversability_threshold))
    (road_d, obs_d), pyr_ms = pyr["card"]
    (road_c, obs_c), pyr_cpu_ms = pyr["cpu"]
    for a, b in zip(road_d + obs_d, road_c + obs_c):
        fail_unless(bool(torch.equal(a.occupancy.cpu(), b.occupancy))
                    and bool(torch.equal(a.color.cpu(), b.color)),
                    "pyramid: card and cpu grids differ")
    n_road = int(road_c[0].occupancy.sum())
    n_obs = int(obs_c[0].occupancy.sum())
    fail_unless(n_road > 1000, f"pyramid: {n_road} road voxels")
    octo_ms = {}
    with tempfile.TemporaryDirectory() as d:
        for ext in (".bt", ".ot"):
            files = {}
            for side, (road, obs) in (("card", (road_d, obs_d)),
                                      ("cpu", (road_c, obs_c))):
                files[side], octo_ms[side + ext] = timed(
                    lambda: save_octomap(os.path.join(d, side + ext), road,
                                         obs), False)
            for (name, pd, _), (_, pc, _) in zip(files["card"],
                                                 files["cpu"]):
                with open(pd, "rb") as f1, open(pc, "rb") as f2:
                    fail_unless(f1.read() == f2.read(),
                                f"octomap {name}{ext}: card and cpu files "
                                f"differ")
                want = n_road if name == "road" else n_obs
                fail_unless(octree_leaves(pd) == want,
                            f"octomap {name}{ext}: leaves != voxels")

    # --- DiSCO signatures of all 64 slots (after the re-stitch)
    new = {"card": new_d, "cpu": new_c}
    centers = [tuple(opt[k, :2].tolist()) for k in range(K)]
    sigs = on_both(lambda side: [disco_signature(slot(new[side], k),
                                                 centers[k])
                                 for k in range(K)])
    sig_d, sig_ms = sigs["card"]
    sig_c, sig_cpu_ms = sigs["cpu"]
    # atan2 differs by an ULP between the card and the CPU, so a point on a
    # sector edge may change bins: hold the polar images to 99.9% of bins
    # and the signatures to cosine similarity 0.9999
    bins_equal = min(
        float((polar_bev(slot(new_d, k), centers[k], 25.0).cpu()
               == polar_bev(slot(new_c, k), centers[k], 25.0))
              .float().mean()) for k in range(K))
    worst_cos = min(float(match_signatures(a.cpu(), b))
                    for (a, _, _), (b, _, _) in zip(sig_d, sig_c))
    sig_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for (a, _, _), (b, _, _) in zip(sig_d, sig_c))
    fail_unless(bins_equal >= 0.999 and worst_cos >= 0.9999,
                f"signatures: bins equal {bins_equal}, cosine {worst_cos}")
    print(f"phase 10 global map K={K} C={C}: ok "
          f"loop_closure={json.dumps(st_d)} card_vs_cpu_max_abs_err={lc_err}"
          f" event_ms={lc_ms:.3f} cpu_event_ms={lc_cpu_ms:.3f}; densify "
          f"G=256 " + " ".join(
              f"order{o}: valid={v} max_abs_dz={dz:.3g} ms={t_d:.3f} "
              f"cpu_ms={t_c:.3f}" for o, (dz, t_d, t_c, v) in dens.items())
          + f" order5_vs_terrain_max={fit_err}; pyramid {shape} "
          f"road={n_road} obstacle={n_obs} bitwise ms={pyr_ms:.3f} "
          f"cpu_ms={pyr_cpu_ms:.3f} octomap_write_ms="
          f"{json.dumps({k: round(v, 3) for k, v in octo_ms.items()})} "
          f"bt_ot_bytes=identical; signatures ms_per_slot={sig_ms / K:.4f} "
          f"cpu_ms_per_slot={sig_cpu_ms / K:.4f} min_cosine={worst_cos:.7f}"
          f" max_rel_err={sig_err:.3g} bev_bins_equal={bins_equal:.5f}",
          flush=True)


def kernel_wrappers():
    """Every kernel wrapper of the port, by name: each counts its launches
    in `.launches`."""
    from gem_tpu_torch.kernels.features import plane_fit_features
    from gem_tpu_torch.kernels.fuse_stream import fuse_stream_aggregate
    from gem_tpu_torch.kernels.segment_stats import segment_stats_sorted

    return {"fuse_stream_aggregate": fuse_stream_aggregate,
            "plane_fit_features": plane_fit_features,
            "segment_stats_sorted": segment_stats_sorted}


def phase_flagship(dev, backend, frames, world):
    """30 flagship frames through ElevationPipeline with `backend`; every
    launch count is set to 0 just before and read just after.  Returns
    (launches by kernel, median step ms)."""
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.core import index_math as im
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline

    cfg = benchmark_config()
    n_frames = len(frames)
    # the kernels of each path, and their launches per frame
    expect = {"stream": {"fuse_stream_aggregate": 1, "plane_fit_features": 1,
                         "segment_stats_sorted": 0},
              "pallas": {"fuse_stream_aggregate": 0, "plane_fit_features": 1,
                         "segment_stats_sorted": 5}}[backend]
    pipe = ElevationPipeline(cfg, device=dev, fuse_backend=backend)
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    times, sheds, fused = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        out = pipe.process(f)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        sheds.append(int(out.metrics["shed_count"]))
        fused.append(int(out.metrics["cells_fused"]))
    launches = {k: w.launches for k, w in wrappers.items()}
    st = pipe.state
    fail_unless(launches == {k: n * n_frames for k, n in expect.items()},
                f"flagship {backend}: launch counts {launches}, expected "
                f"{expect} per frame over {n_frames} frames")
    fail_unless(fused[-1] > 0, "flagship: no cells fused")
    fail_unless(max(sheds) > 0, "flagship: no band was ever shed")
    fail_unless(int(st.submaps.num_submaps) >= 1,
                "flagship: no submap finalized")
    L = cfg.map.length
    for key in ("elevation", "variance", "lowest", "traver", "intensity"):
        plane = getattr(st.map, key)
        fail_unless(tuple(plane.shape) == (L, L)
                    and not bool(torch.isnan(plane).any()),
                    f"flagship: bad {key} plane")
    # accuracy vs the synthetic world's ground truth (the JAX suite's
    # test_elevation_accuracy_vs_ground_truth bounds)
    gsx = torch.arange(L, device=dev).repeat_interleave(L)
    gsy = torch.arange(L, device=dev).repeat(L)
    gx, gy = im.storage_to_geo(gsx, gsy, st.map.start, L)
    px, py = im.geo_index_to_position(gx, gy, st.map.center, L,
                                      cfg.map.resolution)
    elev = st.map.elevation.reshape(-1).cpu().numpy()
    ok = elev != cfg.map.invalid_elevation
    err = elev[ok] - world.height(px.cpu().numpy()[ok], py.cpu().numpy()[ok])
    rmse = float(np.sqrt(np.mean(err ** 2)))
    med = float(np.median(np.abs(err)))
    fail_unless(rmse < 0.08 and med < 0.02,
                f"flagship: rmse {rmse} / median {med} vs ground truth")
    step_ms = statistics.median(times[5:])
    peak = torch.cuda.max_memory_allocated()
    from gem_tpu_torch.io.cli import _global_cloud
    cloud = _global_cloud(pipe, cfg)
    print(f"phase 8 flagship {backend} L=1000 P=131072 raytrace_every=1 "
          f"{n_frames} frames: ok step_ms_median(5..30)={step_ms:.3f} "
          f"step_ms_min={min(times[5:]):.3f} first_frame_ms={times[0]:.1f} "
          f"cells_fused={fused[-1]} shed_frames={sum(s > 0 for s in sheds)} "
          f"num_submaps={int(st.submaps.num_submaps)} rmse_vs_truth={rmse:.5f}"
          f" median_abs_err={med:.5f} launches={launches} "
          f"max_memory_allocated={peak}", flush=True)
    return launches, step_ms, cloud


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 card: {smi}", flush=True)

    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.library()
    print(f"phase 2 build: ok nvcc_s={nvcc_s:.2f} total_s="
          f"{time.perf_counter() - t0:.2f} {path}", flush=True)

    k1, prior = phase_k1(benchmark_config, dev)
    k2_err, k2_ms, k2_plain = phase_k2(benchmark_config(), prior, dev)
    k3, flagship_frame = phase_k3(benchmark_config, dev)
    phase_backends(*flagship_frame)
    del flagship_frame
    phase_parity(dev, "stream")
    phase_parity(dev, "pallas")
    frames, world = [], None
    for f, _, world in synthetic_frames(benchmark_config(), 30,
                                        n_points=131072, speed=0.5, seed=0,
                                        device=dev):
        frames.append(f)
    launches, _, cloud = phase_flagship(dev, "stream", frames, world)
    launches_pallas, _, _ = phase_flagship(dev, "pallas", frames, world)
    del frames
    phase_cli(dev)
    phase_global_map_cli(dev)
    phase_global_map(dev, cloud)

    k1_main = next(r for r in k1 if r[0] == "131k")
    k3_main = next(r for r in k3 if r[0] == "131k")
    kernels = [
        {"name": "fuse_stream_aggregate", "route": "cuda",
         "source": "gem_tpu_torch/csrc/fuse_stream.cu",
         "replaces": "gem_tpu/kernels/fuse_stream.py:521, :213, :757",
         "launches": launches["fuse_stream_aggregate"],
         "max_abs_err": max(r[1] for r in k1),
         "ms": k1_main[2], "plain_ms": k1_main[3]},
        {"name": "plane_fit_features", "route": "cuda",
         "source": "gem_tpu_torch/csrc/features.cu",
         "replaces": "gem_tpu/kernels/features_pallas.py:42",
         "launches": launches["plane_fit_features"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "segment_stats_sorted", "route": "cuda",
         "source": "gem_tpu_torch/csrc/segment_stats.cu",
         "replaces": "gem_tpu/kernels/pallas_scatter.py:40",
         "launches": launches_pallas["segment_stats_sorted"],
         "max_abs_err": max(r[1] for r in k3),
         "ms": k3_main[2], "plain_ms": k3_main[3]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
