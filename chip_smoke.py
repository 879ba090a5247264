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
     backend and every product, a resume from its checkpoint, and the
     kitti preset (orthomosaics stored) with the segment backend.
Then one JSON line of per-kernel results, the nvidia-smi line again, and
the last line {"ok": true, "device": {...}}.  Any failure raises: the
script exits non-zero and prints no result.  It imports no jax.
"""

from __future__ import annotations

import json
import os
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
                         "--checkpoint", p("ck2.npz")]) == 0,
                    "cli: resume failed")
        idx = (int(np.load(p("ck.npz"))["frame_idx"]),
               int(np.load(p("ck2.npz"))["frame_idx"]))
        fail_unless(idx == (30, 35), f"cli: frame_idx {idx} != (30, 35)")
        fail_unless(cli(["run", "--device", dev.type, "--preset", "kitti",
                         "--fuse-backend", "segment", "--frames", "30",
                         "--publish-submaps", p("records")]) == 0,
                    "cli: kitti run failed")
        recs = sorted(os.listdir(p("records")))
        fail_unless(len(recs) >= 1, "cli: no submap record")
        rec = np.load(os.path.join(p("records"), recs[0]))
        ortho = rec["ortho_image"]
        fail_unless(ortho.shape == (Lk, Lk, 3) and ortho.dtype == np.uint8
                    and rec["points"].shape[0] > 0,
                    f"cli: record ortho {ortho.shape} {ortho.dtype}")
    print(f"phase 9 cli: ok benchmark/pallas 30 frames map_points={n_map} "
          f"pngs={L}x{L}x3 resumed_frame_idx={idx[1]} kitti/segment "
          f"records={len(recs)} ortho={ortho.shape} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


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
    print(f"phase 8 flagship {backend} L=1000 P=131072 raytrace_every=1 "
          f"{n_frames} frames: ok step_ms_median(5..30)={step_ms:.3f} "
          f"step_ms_min={min(times[5:]):.3f} first_frame_ms={times[0]:.1f} "
          f"cells_fused={fused[-1]} shed_frames={sum(s > 0 for s in sheds)} "
          f"num_submaps={int(st.submaps.num_submaps)} rmse_vs_truth={rmse:.5f}"
          f" median_abs_err={med:.5f} launches={launches} "
          f"max_memory_allocated={peak}", flush=True)
    return launches, step_ms


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
    launches, _ = phase_flagship(dev, "stream", frames, world)
    launches_pallas, _ = phase_flagship(dev, "pallas", frames, world)
    del frames
    phase_cli(dev)

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
