"""Drive the PyTorch port's mapping pipeline and CLI on one CUDA card.

    python3 chip_smoke.py [--old DIR]

Phases, one line each (times from CUDA events after a warm-up; a kernel's
own time is its device time, the call repeated in one CUDA graph so the
host's launch overhead is left out):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from gem_tpu_torch/csrc (one nvcc per source,
     in parallel);
  3. K1 (fuse_stream_aggregate) vs its plain PyTorch version on the card,
     at the L=1000 flagship: a 131072-point, a 1,048,576-point and a
     4,194,304-point frame and a 131072-point frame with half its lanes
     colored, each launched twice (bitwise equal); then on adversarial
     layouts (one cell holding every point, runs straddling the 256-cell
     tile edges, runs of 1 to 7 points, empty head and tail tiles, all
     padding, no point), with and without color;
  4. K2 (plane_fit_features) vs its plain version at L=1000, bitwise on
     all five planes, on three maps: phase 3's prior, phase 8's 30-frame
     stream map (so this phase runs after phase 8) and a fully valid
     seeded terrain;
  5. K3 (segment_stats_sorted) vs its plain version on the five column
     sets `fuse_pallas` reduces, on a 131072-point and a 1,048,576-point
     frame at L=1000, timed as the kernel alone, through the wrapper, as
     the plain version and as the `torch.segment_reduce` yardstick (in a
     CUDA graph, as the kernel, and launched one by one); then
     on adversarial layouts (one segment, long runs across the blocks'
     edges, empty head and tail gaps, all padding, no point, blocks of 1
     to 7 points with repeated ids, 1,048,576 points, int32 and int64
     ids);
     then, for each of K1, K2 and K3, the robot grid axis: one launch for
     four uneven flagship frames (the third frames of phase 3's drive
     with seeds 1-4 and 131072-81920 points), against the plain version
     with the same robot axis and robot by robot against four single
     launches, bitwise, timed in turns with the four single launches (the
     bounds count every robot's bytes);
  6. the fuse backends on one flagship frame: pallas, segment, sort and
     stream against each other, and the `lowest` plane;
  7. the step on the card (ElevationPipeline: CUDA graphs) vs the same
     step on the CPU (plain versions), L=256, 10 frames, with the stream
     and the pallas backend;
  8. the flagship: L=1000, 131072-point frames, raytrace every frame, 30
     frames at 0.5 m/frame through ElevationPipeline, with shed, keyframe
     and accuracy checks and each kernel's launches counted on the device
     (torch.profiler's kernel events by the kernels' symbols: a replayed
     graph does not call the wrappers): the stream path (K1, K2), then the
     pallas path (K3, K2); K5 on both, three times on the eager first
     frame, then once a taken flush body and twice a taken finalize body
     (its staged flush, the grid snapshot);
  9. the CLI in-process: `run` at the benchmark preset with the pallas
     backend and every product, a resume from its checkpoint (with the
     .bt octomap export), and the kitti preset (orthomosaics stored, the
     npz pyramid) with the segment backend and `--scan 10`; then the
     global-map path, `run --loop-demo --save-octomap x.ot --dense
     --save-submaps` with the stream backend (K1 and K2 launches counted
     on the device), and `selftest`;
 10. the global map at the flagship's own ring (64 slots x 32768 points):
     a loop-closure re-stitch, densify at orders 2 and 5 on one slot, the
     (512, 512, 128) voxel pyramid of phase 8's global cloud with its .bt
     and .ot files, and the DiSCO signatures of all 64 slots, each on the
     card and on the CPU from the same inputs, with both times;
 11. the fleet: four flagship robots (131072-point frames, uneven point
     counts and speeds, 10 frames) through `FleetPipeline` (one CUDA graph
     of one batched step per fleet frame) on the stream path, each robot
     bitwise a separate ElevationPipeline on its frames, K1 and K2
     launched once per fleet frame and K5 twice (counted on the device);
     the same on the pallas path (K3 five times, K2 once and K5 twice per
     fleet frame); then the
     README's
     loop-detect command (`fleet --robots 2 --frames 80 --world-seed 3
     --drift-yaw 8 --drift-x 1.0 --loop-detect --publish-interpr`) on the
     card and on the CPU, the same loops and pairs;
 12. an NCCL process group of one on the card: the sharded loop closure at
     the flagship ring against the same call over a gloo group on the CPU,
     the halo-exchanged stencil at L=1000 against K2, and a sharded
     checkpoint round trip of phase 11's fleet state.  A ring of several
     cards cannot run on a one-card machine; the phase line says so;
 13. the step as CUDA graphs against the eager step (after phase 8, on its
     frames with a loop closure at frame 12): ElevationPipeline under
     set_sync_debug_mode("error") and eager `step`, in turns, bitwise in
     every state leaf and output after every frame, with both step
     medians, the output copy's cost, the device-busy share over frames
     20-29 from torch.profiler and the peak memory of each; scan_steps with
     T=10 against 10 eager steps, twice, bitwise; and (after phase 11) the
     4-robot flagship fleet, FleetPipeline against eager `fleet_step`,
     bitwise, with both fleet-frame medians, and each alone under the
     profiler (device events and ms per fleet frame, busy share, peak
     memory) beside the single step's.  Then the branches (utils/control.py,
     the port's `lax.cond`: a single robot's four conds are CUDA-graph IF
     nodes): the route in use (torch's version, whether it binds
     `begin_capture_to_if_node`, a small cond and when captured, counted
     and replayed both ways); what an untaken branch costs, as IF nodes
     and as the select route's masked forms (each in a graph of 20
     calls); three drives, graph vs eager step bitwise after every frame
     under set_sync_debug_mode("error"), each frame's device events and
     ms from one profile cut by marker kernels: the benchmark preset
     (phase 8's frames, jump at 12), the flagship width with every branch
     taken (a jump, keyframes every 4 m, the 8-frame staging ring
     filling, raytrace every third frame) and the kitti preset
     (orthomosaics and keyframe scans stored); in each, every frame's
     events less the kernel, copy and fill nodes of the IF bodies it took
     is one number, so an untaken body launches nothing.
 14. K4 (refuse_join), the re-stitch's pair join, at phase 10's ring:
     `refuse_rounds` (keys sorted once per event, one K4 launch per round
     with a pair) against the plain per-round join on the card, bitwise,
     launches counted; K4's ms per launch (one CUDA graph) beside its byte
     bound, the key sort's ms, a plain round's ms (one CUDA graph), both
     joins' event ms on the host clock, in turns, and the event's dispatch
     (host ms of the calls, then synchronised) as one native call
     (`refuse_join_rounds`) against one `refuse_join` call per round, in
     turns, with both launch counts.
 15. K5 (compact_append), the submap store's compaction, at the main path's
     shapes (the fleet's (4, 10^6) finalize and (4, 64000) shed append,
     the single robot's 10^6-point finalize and 2,048,000-point staging
     flush, into 32768 rows): against its plain version on the card,
     bitwise in every field, the count and dropped, launches counted; its
     ms in one CUDA graph beside its byte bound, eager, and the plain
     version's ms in one CUDA graph.
Each kernel line gives its bound: the least time the card takes to move
the bytes the call needs and do its fp32 operations (`bound`).  Then the
step and fleet-frame medians, one JSON line of per-kernel results (its
`launches` counted on the device in phase 8),
the nvidia-smi line again, and the last line {"ok": true, "device": {...}}.  Any failure
raises: the script exits non-zero and prints no result.  It imports no jax.

With `--old DIR`, phases 3, 4 and 5 also time an earlier version of K1,
K2 and K3, those of whose sources DIR holds: `fuse_stream.cu` with the
C entry point it had until the robot axis (K1 before its Hopper
redesign, one thread per cell), and `features.cu` and `segment_stats.cu` with the C entry points
they had before theirs (K2 took the resolution as a double; K3 took
per-segment run offsets, found by `torch.searchsorted`, and `fuse_pallas`
passed it a (1, N) zero stack for each unused role).  They are built
beside the current sources with the same nvcc flags, held to the plain
versions (without a robot axis), and timed in turns with the current ones on the same inputs
(earlier, current, current, earlier); `nvcc -Xptxas -v` and a count of
fp64, conversion and call instructions in the SASS of each version are
printed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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

# the H100's published peaks and the kernels' least bytes and operations
from benchmark.yardstick import (bound, k1_bound, k1_bytes, k1_counts,
                                 k2_bound)


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


def graph_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card with the host left
    out: `reps` calls captured in one CUDA graph, replayed once to warm up
    and once under CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
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
    Returns (moved map, point batch)."""
    from gem_tpu_torch.core.move import move
    from gem_tpu_torch.kernels.pointproc import process_points
    from gem_tpu_torch.sensors.models import jacobian_ingredients

    ms, _ = move(state.map, cfg.map, frame.track_position)
    jac = jacobian_ingredients(frame.r_map_base, frame.r_base_sensor,
                               frame.t_base_sensor)
    batch = process_points(
        ms, cfg, frame.points, frame.intensity, frame.valid, frame.transform,
        frame.t_map_base[2], jac[0], frame.pose_cov[3:, 3:], *jac[1:],
        colors=frame.colors)
    return ms, batch


def bitwise_equal(a, b):
    """Equal to the bit (inf and -0.0 included)."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def k1_shape(args):
    """(longest run, most points in one 256-cell tile of K1): the skew a
    frame puts on K1's blocks."""
    offsets = args[0]
    runs = offsets[1:] - offsets[:-1]
    ends = offsets[torch.clamp(torch.arange(
        0, offsets.numel() + 255, 256, device=offsets.device),
        max=offsets.numel() - 1)]
    return int(runs.max()), int((ends[1:] - ends[:-1]).max())


def k1_check(args, what, old=None):
    """K1 on `args` against its plain version (`rows_compare`), a second
    launch bitwise equal to the first, and with `old` (an `Earlier`) the
    earlier K1 against the plain version too.  Returns (W's relative error,
    WH/W's error, the kernel's rows, the plain rows)."""
    from gem_tpu_torch.kernels import fuse_stream as fs

    k = fs.fuse_stream_aggregate(*args)
    again = fs.fuse_stream_aggregate(*args)
    p = fs.fuse_stream_aggregate_plain(*args)
    torch.cuda.synchronize()
    fail_unless(bitwise_equal(k, again), f"K1 {what}: two launches differ")
    rel_w, h_err = rows_compare(k, p)
    if old is not None and old.has("fuse_stream.cu"):
        rows_compare(old.k1(args), p)
    return rel_w, h_err, k, p


def k1_frame(cfg_fn, dev, n, colored):
    """The third frame of phase 3's drive (seed 1, 0.5 m per frame, two
    frames stepped into the map first) at `n` points, through the step's
    stages up to the fuse.  `colored`: half the lanes colored (rows 12-14)
    and 2% lifted by 1 m, so colored start rows are outliers of the prior
    (rows 7-10).  Returns (K1's arguments, moved map, point batch, cfg)."""
    import dataclasses

    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.kernels import fuse_stream as fs
    from gem_tpu_torch.mapping.pipeline import init_pipeline_state, step

    cfg = cfg_fn(max_points=n)
    frames = [f for f, _, _ in synthetic_frames(
        cfg, 3, n_points=n, speed=0.5, seed=1, device=dev)]
    state = init_pipeline_state(cfg, dev)
    for f in frames[:2]:                 # a populated prior to fuse into
        state, _ = step(state, f, cfg)
    frame = frames[2]
    if colored:
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
    ms, batch = frame_batch(state, frame, cfg)
    L = cfg.map.length
    args = (*fs.sort_points(batch, L * L), ms.elevation.reshape(-1),
            ms.variance.reshape(-1), cfg.map)
    return args, ms, batch, cfg


def phase_k1(cfg_fn, dev, old=None):
    """K1 vs plain on four flagship frames (`k1_frame`), then on
    adversarial layouts; returns (kernel line, map).  With `old` (an
    `Earlier` holding fuse_stream.cu), the earlier K1 is held to the plain
    version too and timed in turns with the current one."""
    from gem_tpu_torch.kernels import fuse_stream as fs

    results = []
    prior = None
    cases = [("131k", 1 << 17, False), ("1M", 1 << 20, False),
             ("4M", 1 << 22, False), ("131k_colored", 1 << 17, True)]
    for name, n, colored in cases:
        args, ms, batch, cfg = k1_frame(cfg_fn, dev, n, colored)
        rel_w, h_err, k, p = k1_check(args, name, old)
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
        fns = {"current": lambda: fs.fuse_stream_aggregate(*args)}
        if old is not None and old.has("fuse_stream.cu"):
            fns = {"earlier": lambda: old.k1(args), **fns}
        t_g = in_turns(fns, graph_ms, 20)
        t_k = t_g["current"]
        t_e = cuda_ms(lambda: fs.fuse_stream_aggregate(*args), 20)
        t_p = cuda_ms(lambda: fs.fuse_stream_aggregate_plain(*args), 20)
        b_ms = k1_bound(*k1_counts(args[0]))[0]
        longest, tile_max = k1_shape(args)
        earlier = (f" earlier=ok earlier_kernel_ms={t_g['earlier']:.4f} "
                   f"earlier_share_of_bound={b_ms / t_g['earlier']:.3f}"
                   if "earlier" in t_g else "")
        print(f"phase 3 K1 {name}: ok points={int(batch.valid.sum())} "
              f"cells={int((k[2] > 0).sum())} longest_run={longest} "
              f"max_tile_points={tile_max} selection_rows=bitwise "
              f"run_to_run=bitwise W_max_rel_err={rel_w:.3g} "
              f"H_max_abs_err={h_err:.3g} planes_max_abs_err={plane_err:.3g}"
              f" kernel_ms={t_k:.4f} eager_ms={t_e:.4f} plain_ms={t_p:.4f} "
              f"bound_ms={b_ms:.4f} share_of_bound={b_ms / t_k:.3f}"
              f"{earlier}", flush=True)
        results.append((name, plane_err, t_k, t_p,
                        k1_bound(*k1_counts(args[0])), t_e))
        if name == "131k":
            prior = fused_k
        del args, k, p, batch, ms, fused_k, fused_p
    k1_adversarial(cfg_fn, dev, old)
    return results, prior


def k1_layouts(rng, L, P=1 << 16):
    """Sorted-point layouts that stress K1's owners (a block owns 256
    consecutive cells and cuts their points into 8 warp parts by
    position), as {name: (cell ids, valid mask)} over up to P lanes at L x L
    cells: every point in one cell; runs of 1-3000 points whose cells
    straddle 256-cell tile edges; runs of 1-7 points; points only in the
    middle third (empty head and tail tiles); every lane padding; no
    point at all."""
    S = L * L
    every = np.ones(P, bool)
    edges = sorted({k * 256 + d for k in (1, 2, 3, 9, S // 512, S // 256 - 1)
                    for d in (-1, 0)})
    lengths = rng.integers(1, 3000, len(edges))
    edge_ids = np.repeat(np.asarray(edges), lengths)
    short_cells = np.sort(rng.choice(S, 20000, replace=False))
    short_ids = np.repeat(short_cells, rng.integers(1, 8, len(short_cells)))
    mid = rng.integers(S // 3, 2 * S // 3, P)
    return {
        "one_cell": (np.full(P, S // 2 + 77), every),
        "tile_edge_runs": (edge_ids, np.ones(len(edge_ids), bool)),
        "runs_of_1_to_7": (short_ids, np.ones(len(short_ids), bool)),
        "empty_head_and_tail_tiles": (mid, every),
        "all_padding": (rng.integers(0, S, 4096), np.zeros(4096, bool)),
        "no_points": (np.zeros(0, np.int64), np.zeros(0, bool)),
    }


def layout_batch(rng, cells, valid, dev):
    """A PointBatch on `cells` whose gated sums are exact in f32 in any
    order, so K1 must equal the plain version in every row: heights on a
    1/16 m grid in [-1, 1] m, 10% lifted 2.5 m (outlier start rows), and
    variances of 1/16, 1/32 or 1/64 (weights 16-64, exact v ties), so each
    w and w*h is an integer and a cell's sums stay below 2^24 for up to
    65536 points; half the lanes colored."""
    from gem_tpu_torch.kernels.pointproc import PointBatch

    P = len(cells)
    col = np.where(rng.random(P) < 0.5, rng.integers(1, 1 << 24, P), 0)
    h = (np.clip(np.round(rng.normal(size=P) * 0.3 * 16) / 16, -1, 1)
         + (rng.random(P) < 0.1) * 2.5)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(dev)
    return PointBatch(
        xy=torch.zeros((P, 2), device=dev), height=t(h, np.float32),
        variance=t(2.0 ** -rng.integers(4, 7, P), np.float32),
        cell=t(cells, np.int32), color=t(col, np.int32),
        intensity=t(np.where(col != 0, rng.integers(1, 4, P), 0),
                    np.float32),
        valid=t(valid, bool))


def k1_adversarial(cfg_fn, dev, old=None):
    """K1 vs plain, every row equal (`layout_batch` makes the sums exact),
    and a second launch bitwise, on `k1_layouts` at the flagship's L=1000,
    with and without color, over a prior with half its cells fused."""
    from gem_tpu_torch.kernels import fuse_stream as fs

    cfg = cfg_fn()
    L = cfg.map.length
    rng = np.random.default_rng(31)
    occ = rng.random(L * L) < 0.5
    elev0 = torch.from_numpy(np.where(occ, rng.normal(size=L * L) * 0.3,
                                      cfg.map.invalid_elevation)
                             .astype(np.float32)).to(dev)
    var0 = torch.from_numpy(np.where(occ, rng.uniform(1e-4, 0.05, L * L),
                                     cfg.map.invalid_variance)
                            .astype(np.float32)).to(dev)
    names = []
    for name, (cells, valid) in k1_layouts(rng, L).items():
        batch = layout_batch(rng, cells, valid, dev)
        for with_color in (True, False):
            args = (*fs.sort_points(batch, L * L, with_color), elev0, var0,
                    cfg.map)
            what = f"{name}/{'color' if with_color else 'no_color'}"
            kw = {"with_color": with_color}
            k = fs.fuse_stream_aggregate(*args, **kw)
            again = fs.fuse_stream_aggregate(*args, **kw)
            p = fs.fuse_stream_aggregate_plain(*args, **kw)
            torch.cuda.synchronize()
            fail_unless(bitwise_equal(k, again),
                        f"K1 {what}: two launches differ")
            fail_unless(bool(torch.equal(k, p)),
                        f"K1 {what}: rows differ from the plain version")
            if old is not None and old.has("fuse_stream.cu"):
                fail_unless(bool(torch.equal(old.k1(args, **kw), p)),
                            f"earlier K1 {what}: rows differ from plain")
            names.append(f"{what}:{int(batch.valid.sum())}")
    print(f"phase 3 K1 adversarial L={L}: ok rows=equal run_to_run=bitwise "
          f"layouts/points={names}", flush=True)


def terrain_map(cfg, dev):
    """A fully valid L x L map: the seeded relief of `terrain` plus 1 cm
    noise, every cell fused, the window rolled to (123, 457)."""
    from gem_tpu_torch.core.state import init_map_state

    L = cfg.map.length
    g = np.arange(L) * cfg.map.resolution
    rng = np.random.default_rng(11)
    elev = (terrain(g[:, None], g[None, :])
            + 0.01 * rng.standard_normal((L, L))).astype(np.float32)
    return init_map_state(cfg.map, dev).replace(
        elevation=torch.from_numpy(elev).to(dev),
        start=torch.tensor([123, 457], dtype=torch.int32, device=dev))


class Earlier:
    """K1, K2 and K3 built from the earlier sources in `src_dir` (`--old`),
    those of them that it holds, bound with their earlier C entry points,
    and called as their earlier wrappers called them."""

    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    SIGNATURES = {
        # K1 before its redesign (one thread per cell): the entry point
        # it kept until the robot axis
        "fuse_stream.cu": ("gem_fuse_stream_aggregate",
                           (_P,) * 8 + (_I, _F, _F, _F, _I, _I, _P)),
        # K2 before its redesign: ..., L, resolution (double), ...
        "features.cu": ("gem_plane_fit_features",
                        (_P,) * 7 + (_I, ctypes.c_double) + (_F,) * 5
                        + (_P,)),
        # K3 before its redesign: offsets (S + 1), columns, results, n,
        # S, F per role, stream
        "segment_stats.cu": ("gem_segment_stats_sorted",
                             (_P,) * 7 + (ctypes.c_int64,) + (_I,) * 4
                             + (_P,))}

    def __init__(self, src_dir):
        from gem_tpu_torch.kernels import _build

        self.sources = [s for s in self.SIGNATURES
                        if os.path.exists(os.path.join(src_dir, s))]
        fail_unless(self.sources, f"--old {src_dir}: none of "
                    f"{list(self.SIGNATURES)} there")
        out = os.path.join(os.path.dirname(_build.BUILD_DIR), "earlier")
        os.makedirs(out, exist_ok=True)
        jobs = {}
        for who, d in (("earlier", src_dir), ("current", _build.CSRC)):
            for src in self.sources:
                obj = os.path.join(out, f"{who}_{src[:-3]}.o")
                jobs[who, src, obj] = subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                     "-c", "-o", obj, os.path.join(d, src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        for (who, src, obj), proc in jobs.items():
            log = proc.communicate()[0]
            fail_unless(proc.returncode == 0, f"nvcc failed on {who} {src}:"
                        f"\n{log}")
            sass = subprocess.run([cuobjdump, "-sass", obj], check=True,
                                  capture_output=True, text=True).stdout
            ops = {op: len(re.findall(rf"\b{op}\b", sass))
                   for op in ("DMUL", "DADD", "DFMA", "F2F", "CALL")}
            regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                    if "registers" in ln]
            print(f"earlier: {who} {src} ptxas={regs} sass_ops={ops}",
                  flush=True)
        so = os.path.join(out, "libearlier.so")
        subprocess.run([_build._nvcc(), "-shared", "-o", so,
                        *(obj for (who, _, obj) in jobs if who == "earlier")],
                       check=True)
        self.lib = ctypes.CDLL(so)
        for src in self.sources:
            name, argtypes = self.SIGNATURES[src]
            getattr(self.lib, name).argtypes = list(argtypes)
            getattr(self.lib, name).restype = ctypes.c_int

    def has(self, src):
        """Whether the earlier `src` (e.g. "features.cu") was built."""
        return src in self.sources

    def k1(self, args, with_lowest=True, with_color=True):
        """The earlier K1 on the current wrapper's arguments: (16, ncell)."""
        from gem_tpu_torch.kernels import _build

        offsets, h, v, inten, colf, elev0, var0, mcfg = args
        ncell = offsets.numel() - 1
        out = torch.empty((16, ncell), dtype=torch.float32, device=h.device)
        err = self.lib.gem_fuse_stream_aggregate(
            offsets.data_ptr(), h.data_ptr(), v.data_ptr(), inten.data_ptr(),
            colf.data_ptr(), elev0.data_ptr(), var0.data_ptr(),
            out.data_ptr(), ncell, mcfg.invalid_elevation,
            mcfg.min_variance, mcfg.mahalanobis_threshold, int(with_lowest),
            int(with_color), _build.stream_of(h))
        _build.check(err, "earlier K1")
        return out

    def k2(self, m, mcfg):
        """The earlier K2 wrapper (the same checks as the current one):
        ((4, L, L) planes, (L, L) count)."""
        from gem_tpu_torch.kernels import _build
        from gem_tpu_torch.utils.precision import f32_recip

        elev, start, L = m.elevation, m.start, mcfg.length
        if elev.shape != (L, L) or elev.dtype != torch.float32 \
                or not elev.is_contiguous():
            raise ValueError("earlier K2: bad elevation")
        if start.dtype != torch.int32 or start.device != elev.device \
                or start.shape != (2,) or not start.is_contiguous():
            raise ValueError("earlier K2: bad start")
        planes = torch.empty((4, L, L), dtype=torch.float32,
                             device=elev.device)
        count = torch.empty((L, L), dtype=torch.int32, device=elev.device)
        err = self.lib.gem_plane_fit_features(
            elev.data_ptr(), start.data_ptr(),
            *(p.data_ptr() for p in planes), count.data_ptr(), L,
            mcfg.resolution, mcfg.invalid_elevation,
            mcfg.invalid_traversability, f32_recip(mcfg.slope_critical),
            f32_recip(mcfg.rough_critical),
            float(mcfg.feature_min_neighbors), _build.stream_of(elev))
        _build.check(err, "earlier K2")
        return planes, count

    @staticmethod
    def k3_args(args):
        """One call's arguments as the earlier `fuse_pallas` passed them:
        a (1, N) zero stack for each unused role."""
        ids_s, sv, mv, xv, S = args
        zeros = torch.zeros((1, ids_s.shape[0]), device=ids_s.device)
        return (ids_s, *(x if x.shape[0] else zeros for x in (sv, mv, xv)),
                S)

    def k3(self, args, offsets=None, outs=None):
        """The earlier K3 on `k3_args(...)`: as its wrapper ran it (offsets
        by `torch.searchsorted`, fresh outputs), or with `offsets` and
        `outs` given, the kernel alone.  Returns (sums, mins, maxs)."""
        from gem_tpu_torch.kernels import _build

        ids_s, sv, mv, xv, S = args
        if offsets is None:
            offsets = torch.searchsorted(ids_s, torch.arange(
                S + 1, device=ids_s.device, dtype=ids_s.dtype))
        if outs is None:
            outs = [torch.empty((x.shape[0], S), dtype=torch.float32,
                                device=ids_s.device) for x in (sv, mv, xv)]
        err = self.lib.gem_segment_stats_sorted(
            offsets.data_ptr(), sv.data_ptr(), mv.data_ptr(), xv.data_ptr(),
            *(o.data_ptr() for o in outs), ids_s.shape[0], S, sv.shape[0],
            mv.shape[0], xv.shape[0], _build.stream_of(ids_s))
        _build.check(err, "earlier K3")
        return outs


def in_turns(fns, timer, reps):
    """{name: mean ms} of each closure, timed in turns (a, b, b, a for two)
    so that a drift of the card's clock falls on both alike."""
    names = list(fns)
    t = {k: 0.0 for k in names}
    order = names + names[::-1]
    for k in order:
        t[k] += timer(fns[k], reps) / order.count(k)
    return t


def phase_k2(cfg, states, old=None):
    """K2 vs its plain version, bitwise on all five planes, on each named
    map state; returns {name: (fitted cells, kernel ms, plain ms, bound ms,
    bound_by, eager ms)}: the kernel's device time from a CUDA graph, and
    the wrapper launched one by one.  The bound counts 24 bytes per cell
    (the elevation read, four float planes and the count written) and
    K2_OPS_FITTED fp32 operations per fitted cell, K2_OPS_COUNT per other
    cell.  With `old` (an `Earlier`), the earlier K2 is held to the plain
    version too and timed in turns with the current one."""
    from gem_tpu_torch.kernels import features as ft

    mcfg = cfg.map
    out = {}
    for name, m in states.items():
        k = ft.plane_fit_features(m, mcfg)
        p = ft.compute_features(m, mcfg)
        torch.cuda.synchronize()
        for key in ("slope", "rough", "traver", "normal_z", "neighbor_count"):
            fail_unless(bool(torch.equal(getattr(k, key), getattr(p, key))),
                        f"K2 {name}: {key} differs from the plain version")
        cells = mcfg.length ** 2
        fitted = int(((m.elevation != mcfg.invalid_elevation)
                      & (p.neighbor_count >= mcfg.feature_min_neighbors))
                     .sum())
        fail_unless(fitted > 0, f"K2 {name}: no fitted cell")
        b_ms, b_by = k2_bound(cells, fitted)
        fns = {"current": lambda: ft.plane_fit_features(m, mcfg)}
        earlier = ""
        if old is not None and old.has("features.cu"):
            planes, count = old.k2(m, mcfg)
            fail_unless(torch.equal(count, p.neighbor_count) and all(
                torch.equal(planes[i], getattr(p, key)) for i, key in
                enumerate(("slope", "rough", "traver", "normal_z"))),
                f"K2 {name}: the earlier version differs from plain")
            fns = {"earlier": lambda: old.k2(m, mcfg), **fns}
        t_g = in_turns(fns, graph_ms, 50)
        t_eg = in_turns(fns, cuda_ms, 50)
        t_k, t_e = t_g["current"], t_eg["current"]
        t_p = cuda_ms(lambda: ft.compute_features(m, mcfg), 5)
        if "earlier" in t_g:
            earlier = (f" earlier=bitwise earlier_kernel_ms="
                       f"{t_g['earlier']:.4f} earlier_eager_ms="
                       f"{t_eg['earlier']:.4f}")
        print(f"phase 4 K2 L={mcfg.length} {name}: ok planes=bitwise "
              f"fitted={fitted} kernel_ms={t_k:.4f} eager_ms={t_e:.4f} "
              f"plain_ms={t_p:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / t_k:.3f}{earlier}", flush=True)
        out[name] = (fitted, t_k, t_p, b_ms, b_by, t_e)
    return out


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
    one pallas fuse makes on this frame, recorded around the real call."""
    from gem_tpu_torch.kernels import fuse as fz

    calls = []
    real = fz.segment_stats_sorted

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    fz.segment_stats_sorted = record
    try:
        fz.fuse(ms, cfg, batch, backend="pallas")
    finally:
        fz.segment_stats_sorted = real
    fail_unless(len(calls) == 5, f"fuse_pallas made {len(calls)} calls")
    return calls


def k3_check(args, got, what):
    """Hold (sums, mins, maxs) against K3's plain version on one call's
    arguments: mins and maxs bitwise, each sum within 1e-5 of the sum of
    its terms' magnitudes (the plain version adds with atomics in no fixed
    order).  Returns the max abs error of the sums."""
    from gem_tpu_torch.kernels import segment_stats as sst

    ids_s, sv, mv, xv, S = args
    ks, kn, kx = got
    ps, pn, px = sst.segment_stats_sorted_plain(*args)
    mag = sst.segment_stats_sorted_plain(ids_s, sv.abs(), mv, xv, S)[0]
    torch.cuda.synchronize()
    fail_unless(ks.shape == ps.shape and kn.shape == pn.shape
                and kx.shape == px.shape, f"{what}: result shapes differ")
    fail_unless(bool(torch.equal(kn, pn) and torch.equal(kx, px)),
                f"{what}: mins/maxs differ from the plain version")
    d = (ks - ps).abs()
    err = float(d.max()) if d.numel() else 0.0
    fail_unless(bool((d <= 1e-5 * mag).all()),
                f"{what}: sums differ by up to {err}")
    return err


def k3_compare(args):
    """K3 against its plain version on one call's arguments (`k3_check`)."""
    from gem_tpu_torch.kernels import segment_stats as sst

    return k3_check(args, sst.segment_stats_sorted(*args, with_spill=False)
                    [:3], "K3")


def k3_kernel_only(args):
    """A closure that launches K3's kernel alone on one call's arguments,
    into outputs allocated once: the wrapper's checks and allocations left
    out."""
    from gem_tpu_torch.kernels import _build

    ids_s, sv, mv, xv, S = args
    lead = ids_s.shape[:-1]
    outs = [torch.empty((x.shape[0],) + lead + (S,), dtype=torch.float32,
                        device=ids_s.device) for x in (sv, mv, xv)]
    lib = _build.library()
    n = ids_s.shape[-1]
    call = (ids_s.data_ptr(), int(ids_s.dtype == torch.int64),
            sv.data_ptr(), mv.data_ptr(), xv.data_ptr(),
            *(o.data_ptr() for o in outs), n, S, ids_s.numel() // max(n, 1),
            sv.shape[0], mv.shape[0], xv.shape[0])
    launched = ctypes.c_int(0)

    def run():
        # the stream is read at each call: a CUDA graph captures on its own
        _build.check(lib.gem_segment_stats_sorted(
            *call, _build.stream_of(ids_s), ctypes.byref(launched)), "K3")
        return outs   # held by the closure: the kernel writes into them
    return run


def k3_library_robots(args):
    """The yardstick with a robot axis: one `torch.segment_reduce` call per
    role over every robot's (R, N) sorted columns, with offsets computed
    beforehand; each robot's pad lanes fall into one extra segment of its
    own, which is cut off.  Returns (closure, results as (F, R, S) per
    role)."""
    ids_s, sv, mv, xv, S = args
    R, n = ids_s.shape
    offs = torch.searchsorted(ids_s, torch.arange(
        S + 1, device=ids_s.device, dtype=ids_s.dtype).expand(
        R, S + 1).contiguous()).to(torch.int64)
    offs = offs + n * torch.arange(R, device=ids_s.device)[:, None]
    offsets = torch.cat([offs.reshape(-1), offs.new_full((1,), R * n)])
    roles = [(x.reshape(x.shape[0], -1).t().contiguous(), kind, init)
             for x, kind, init in ((sv, "sum", 0.0), (mv, "amin",
                                                       float("inf")),
                                   (xv, "amax", float("-inf")))
             if x.shape[0]]

    def run():
        return [torch.segment_reduce(d, kind, offsets=offsets, axis=0,
                                     initial=init, unsafe=True)
                for d, kind, init in roles]

    def results():
        out = iter(run())
        return tuple(
            next(out).reshape(R, S + 1, -1)[:, :S].permute(2, 0, 1)
            if x.shape[0] else torch.empty((0, R, S), device=x.device)
            for x in (sv, mv, xv))
    return run, results


def k3_library(args):
    """The yardstick: one `torch.segment_reduce` call per role of the call
    (sum, amin, amax), on the same sorted columns with offsets computed
    beforehand.  Returns (closure, results as (F, S) per role)."""
    ids_s, sv, mv, xv, S = args
    if ids_s.dim() == 2:
        return k3_library_robots(args)
    offsets = torch.searchsorted(ids_s, torch.arange(
        S + 1, device=ids_s.device, dtype=ids_s.dtype)).to(torch.int64)
    m = int(offsets[-1])
    roles = [(x.t()[:m].contiguous(), kind, init) for x, kind, init in (
        (sv, "sum", 0.0), (mv, "amin", float("inf")),
        (xv, "amax", float("-inf"))) if x.shape[0]]

    def run():
        return [torch.segment_reduce(d, kind, offsets=offsets, axis=0,
                                     initial=init, unsafe=True)
                for d, kind, init in roles]

    def results():
        """The yardstick's results as (sums, mins, maxs) of (F, S)."""
        out = iter(run())
        return tuple(next(out).t() if x.shape[0] else
                     torch.empty((0, S), device=x.device) for x in (sv, mv, xv))
    return run, results


def k3_bound(args):
    """K3's least bytes for one call: the sorted ids and the used columns
    read once, the (F, S) results written once; with a robot axis, every
    robot's."""
    ids_s, sv, mv, xv, S = args
    f_in = sv.shape[0] + mv.shape[0] + xv.shape[0]
    n = ids_s.numel()
    robots = n // max(ids_s.shape[-1], 1)
    return bound(n * ids_s.element_size() + f_in * n * 4
                 + f_in * S * robots * 4)


def sparse_block_ids(rng, S, block=2048):
    """Ids that put 1 to 7 points in each of 70 blocks of `block`
    segments (K3's owners), fewer than a block's 8 warp parts, so parts
    between two carries of one run stay empty: per count, five cell
    patterns (all in one cell, the first two sharing, the last two
    sharing, pairs, random repeats over three cells), each at the block's
    first cells and at cells 300 apart; every other block empty."""
    pats = []
    for m in range(1, 8):
        k = np.arange(m)
        pats += [np.zeros(m, np.int64), np.maximum(k - 1, 0),
                 np.minimum(k, max(m - 2, 0)), k // 2,
                 np.sort(rng.integers(0, 3, m))]
    cases = [p * spread for spread in (1, 300) for p in pats]
    blocks = np.sort(rng.choice(S // block, len(cases), replace=False))
    return np.concatenate([b * block + c for b, c in zip(blocks, cases)]
                          + [np.full(5, S, np.int64)])


def k3_adversarial(dev):
    """K3 vs plain on layouts that stress the owners (blocks of 2048
    segments, their points cut into 8 warp parts by position): every point
    in one segment; runs of 100-3000 points, longer than a warp's 256-point
    step, at ids that straddle 256-segment marks and the blocks' edges;
    empty head and tail gaps; every lane padding; no point at all; blocks
    of 1 to 7 points with repeated ids (`sparse_block_ids`), and 3 or 4
    points in all; 1,048,576 points over 10^6 segments; and int64 ids."""
    S = 1000 * 1000
    rng = np.random.default_rng(21)

    def run_ids(heads, lengths, n_pad):
        ids = np.repeat(np.asarray(heads, np.int64), lengths)
        return np.concatenate([ids, np.full(n_pad, S, np.int64)])

    heads = sorted({k * 256 + d for k in (1, 2, 8, 9, 3905) for d in (-1, 0)}
                   | set(rng.choice(S, 40, replace=False).tolist()))
    layouts = {
        "one_segment": np.full(1 << 17, 54321, np.int64),
        "long_runs_on_owner_edges": run_ids(
            heads, rng.integers(100, 3000, len(heads)), 777),
        "head_and_tail_gaps": np.concatenate([np.sort(rng.integers(
            S // 3, 2 * S // 3, 100000)), np.full(1000, S)]),
        "all_padding": np.full(4096, S, np.int64),
        "no_points": np.zeros(0, np.int64),
        "sparse_blocks": sparse_block_ids(rng, S),
        "three_points_one_cell": np.full(3, 54321, np.int64),
        "four_points_first_two_share": np.array([54321, 54321, 54322,
                                                 60000], np.int64),
        "1M_points": np.sort(np.where(rng.random(1 << 20) < 0.95,
                                      rng.integers(0, S, 1 << 20), S)),
    }
    errs = {}
    for name, ids in layouts.items():
        for dtype in ((torch.int32, torch.int64) if name != "1M_points"
                      else (torch.int32,)):
            n = len(ids)
            t = torch.from_numpy(np.sort(ids)).to(dev, dtype)
            cols = [torch.from_numpy(rng.standard_normal((f, n))
                                     .astype(np.float32)).to(dev)
                    for f in (2, 2, 1)]
            errs[f"{name}/{str(dtype)[6:]}"] = k3_compare((t, *cols, S))
    print(f"phase 5 K3 adversarial S={S}: ok mins_maxs=bitwise "
          f"sums_max_abs_err={json.dumps(errs)}", flush=True)
    return max(errs.values())


def phase_k3(cfg_fn, dev, old=None):
    """K3 vs plain on the five column sets of fuse_pallas, on the third
    frame of a 131072-point and of a 1,048,576-point drive (two warm frames
    through the pallas step first), then on the adversarial layouts.
    Times per call and per frame: the kernel alone (device time, from a
    CUDA graph), the wrapper as fuse_pallas calls it, the plain version and
    the `torch.segment_reduce` yardstick, timed in a CUDA graph as the
    kernel is (`library`) and launched one by one (`library_eager`).  With
    `old` (an `Earlier` holding segment_stats.cu), the earlier K3 is held
    to the plain version on its own arguments and its kernel and wrapper
    are timed in turns with the current ones.
    Returns (results, adversarial max error, the 131k frame's (cfg, moved
    map, batch))."""
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.kernels import segment_stats as sst
    from gem_tpu_torch.mapping.pipeline import init_pipeline_state, step

    results, flagship = {}, None
    for name, n in (("131k", 1 << 17), ("1M", 1 << 20)):
        cfg = cfg_fn(max_points=n)
        frames = [f for f, _, _ in synthetic_frames(
            cfg, 3, n_points=n, speed=0.5, seed=1, device=dev)]
        state = init_pipeline_state(cfg, dev)
        for f in frames[:2]:
            state, _ = step(state, f, cfg, fuse_backend="pallas")
        ms, batch = frame_batch(state, frames[2], cfg)
        calls = fuse_pallas_calls(ms, cfg, batch)
        err = max(k3_compare(a) for a in calls)
        t = {"kernel": 0.0, "wrapper": 0.0, "plain": 0.0, "library": 0.0,
             "library_eager": 0.0, "bound": 0.0}
        k3_old = old is not None and old.has("segment_stats.cu")
        if k3_old:
            t.update(earlier_kernel=0.0, earlier_wrapper=0.0)
        for a in calls:
            lib_run, lib_results = k3_library(a)
            k3_check(a, lib_results(), "K3 yardstick (segment_reduce)")
            kernels = {"kernel": k3_kernel_only(a)}
            wrappers = {"wrapper": lambda: sst.segment_stats_sorted(
                *a, with_spill=False)}
            if k3_old:
                o = Earlier.k3_args(a)
                got = old.k3(o)
                k3_check(a, [x[:a[i + 1].shape[0]] for i, x in
                             enumerate(got)], "earlier K3")
                offsets = torch.searchsorted(o[0], torch.arange(
                    o[4] + 1, device=dev, dtype=o[0].dtype))
                kernels = {"earlier_kernel": lambda: old.k3(o, offsets, got),
                           **kernels}
                wrappers = {"earlier_wrapper": lambda: old.k3(o), **wrappers}
            for k, v in in_turns(kernels, graph_ms, 50).items():
                t[k] += v
            for k, v in in_turns(wrappers, cuda_ms, 50).items():
                t[k] += v
            t["plain"] += cuda_ms(lambda: sst.segment_stats_sorted_plain(*a),
                                  20)
            t["library"] += graph_ms(lib_run, 50)
            t["library_eager"] += cuda_ms(lib_run, 20)
            t["bound"] += k3_bound(a)[0]
        print(f"phase 5 K3 {name}: ok points={int(batch.valid.sum())} "
              f"calls=5 F={[tuple(x.shape[0] for x in a[1:4]) for a in calls]}"
              f" mins_maxs=bitwise sums_max_abs_err={err:.3g} per_frame_ms: "
              + " ".join(f"{k}={v:.4f}" for k, v in t.items())
              + f" share_of_bound={t['bound'] / t['kernel']:.3f}",
              flush=True)
        results[name] = (err, {k: v / 5 for k, v in t.items()})
        if name == "131k":
            flagship = (cfg, ms, batch)
    adv_err = k3_adversarial(dev)
    return results, adv_err, flagship


def robot_axis_frames(cfg_fn, dev, R=4, n=1 << 17):
    """R uneven flagship frames: robot r's is the third frame of phase
    3's drive with seed 1 + r and n - 16384 r points (two frames stepped
    into its map first), through the step's stages up to the fuse.
    Returns (cfg, stacked moved maps, stacked point batches, the maps,
    the batches)."""
    from gem_tpu_torch.io.replay import synthetic_frames
    from gem_tpu_torch.mapping.pipeline import init_pipeline_state, step
    from gem_tpu_torch.utils.tree import tree_map

    cfg = cfg_fn(max_points=n)
    maps, batches = [], []
    for r in range(R):
        frames = [f for f, _, _ in synthetic_frames(
            cfg, 3, n_points=n - 16384 * r, speed=0.5, seed=1 + r,
            device=dev)]
        state = init_pipeline_state(cfg, dev)
        for f in frames[:2]:
            state, _ = step(state, f, cfg)
        ms, batch = frame_batch(state, frames[2], cfg)
        maps.append(ms)
        batches.append(batch)
    stack = lambda xs: tree_map(lambda *t: torch.stack(t), xs[0], *xs[1:])
    return cfg, stack(maps), stack(batches), maps, batches


def phase_robot_axis(cfg_fn, dev):
    """Phases 3-5 with the robot axis: K1, K2 and K3 launched once for 4
    uneven flagship frames (`robot_axis_frames`), each against its plain
    version with the same robot axis (as in phases 3-5) and robot by
    robot against its single launch on that robot's inputs, bitwise.
    Times: the robot-axis kernel (device time, CUDA graph), the four
    single launches in turns with it, the plain version, and for K3 the
    `torch.segment_reduce` yardstick; the bounds count every robot's
    bytes.  Returns {kernel: (max abs err, ms, plain ms, (bound ms,
    by), library ms or None, singles ms)}."""
    from gem_tpu_torch.kernels import features as ft
    from gem_tpu_torch.kernels import fuse_stream as fs
    from gem_tpu_torch.kernels import segment_stats as sst
    from gem_tpu_torch.utils.tree import tree_map

    cfg, ms, batch, maps, batches = robot_axis_frames(cfg_fn, dev)
    R, L = len(maps), cfg.map.length
    pts = [int(b.valid.sum()) for b in batches]
    out = {}

    # --- K1 -----------------------------------------------------------
    args = (*fs.sort_points(batch, L * L), ms.elevation.reshape(R, -1),
            ms.variance.reshape(R, -1), cfg.map)
    k = fs.fuse_stream_aggregate(*args)
    again = fs.fuse_stream_aggregate(*args)
    p = fs.fuse_stream_aggregate_plain(*args)
    torch.cuda.synchronize()
    fail_unless(tuple(k.shape) == (R, 16, L * L) and bitwise_equal(k, again),
                "K1 R=4: shape or two launches differ")
    errs = [rows_compare(k[r], p[r]) for r in range(R)]
    singles = [(*fs.sort_points(batches[r], L * L),
                maps[r].elevation.reshape(-1), maps[r].variance.reshape(-1),
                cfg.map) for r in range(R)]
    for r in range(R):
        fail_unless(bitwise_equal(k[r], fs.fuse_stream_aggregate(
            *singles[r])), f"K1 R=4: robot {r} differs from its single "
            "launch")
    fused_k = fs.apply_aggregates(ms, cfg, k)
    fused_p = fs.apply_aggregates(ms, cfg, p)
    plane_err = max(float((getattr(fused_k, key) - getattr(fused_p, key))
                          .abs().max())
                    for key in ("elevation", "variance", "lowest",
                                "intensity"))
    fail_unless(plane_err <= 5e-5 and bool(torch.equal(fused_k.color,
                                                        fused_p.color)),
                f"K1 R=4: planes differ by {plane_err}")
    t = in_turns({"robots": lambda: fs.fuse_stream_aggregate(*args),
                  "singles": lambda: [fs.fuse_stream_aggregate(*a)
                                      for a in singles]}, graph_ms, 10)
    t_p = cuda_ms(lambda: fs.fuse_stream_aggregate_plain(*args), 5)
    b = bound(sum(k1_bytes(*k1_counts(o)) for o in args[0]))
    print(f"phase 3 K1 R={R} (robot grid axis, one launch) points={pts}: "
          f"ok selection_rows=bitwise robots_vs_single_launches=bitwise "
          f"run_to_run=bitwise W_max_rel_err={max(e[0] for e in errs):.3g} "
          f"H_max_abs_err={max(e[1] for e in errs):.3g} planes_max_abs_err="
          f"{plane_err:.3g} kernel_ms={t['robots']:.4f} "
          f"four_single_launches_ms={t['singles']:.4f} plain_ms={t_p:.4f} "
          f"bound_ms={b[0]:.4f} (R x the bytes) share_of_bound="
          f"{b[0] / t['robots']:.3f}", flush=True)
    out["fuse_stream_aggregate"] = (plane_err, t["robots"], t_p, b, None,
                                    t["singles"])
    del args, singles, k, again, p, fused_p

    # --- K2, on the fused maps ------------------------------------------
    mcfg = cfg.map
    k = ft.plane_fit_features(fused_k, mcfg)
    p = ft.compute_features(fused_k, mcfg)
    torch.cuda.synchronize()
    keys = ("slope", "rough", "traver", "normal_z", "neighbor_count")
    for key in keys:
        fail_unless(bool(torch.equal(getattr(k, key), getattr(p, key))),
                    f"K2 R=4: {key} differs from the plain version")
    one = [tree_map(lambda x: x[r].contiguous(), fused_k) for r in range(R)]
    for r in range(R):
        s = ft.plane_fit_features(one[r], mcfg)
        fail_unless(all(bitwise_equal(getattr(k, key)[r], getattr(s, key))
                        for key in keys),
                    f"K2 R=4: robot {r} differs from its single launch")
    cells = R * L * L
    fitted = int(((fused_k.elevation != mcfg.invalid_elevation)
                  & (p.neighbor_count >= mcfg.feature_min_neighbors)).sum())
    b = k2_bound(cells, fitted)
    t = in_turns({"robots": lambda: ft.plane_fit_features(fused_k, mcfg),
                  "singles": lambda: [ft.plane_fit_features(m, mcfg)
                                      for m in one]}, graph_ms, 20)
    t_p = cuda_ms(lambda: ft.compute_features(fused_k, mcfg), 2)
    print(f"phase 4 K2 R={R} L={L} (robot grid axis, one launch): ok "
          f"planes=bitwise robots_vs_single_launches=bitwise fitted="
          f"{fitted} kernel_ms={t['robots']:.4f} four_single_launches_ms="
          f"{t['singles']:.4f} plain_ms={t_p:.4f} bound_ms={b[0]:.4f} "
          f"({b[1]}) share_of_bound={b[0] / t['robots']:.3f}", flush=True)
    out["plane_fit_features"] = (0.0, t["robots"], t_p, b, None,
                                 t["singles"])
    del k, p, one, fused_k

    # --- K3, on the five calls of the pallas fuse -----------------------
    calls = fuse_pallas_calls(ms, cfg, batch)
    err = 0.0
    tot = {"kernel": 0.0, "singles": 0.0, "wrapper": 0.0, "plain": 0.0,
           "library": 0.0, "bound": 0.0}
    for a in calls:
        ids_s, sv, mv, xv, S = a
        fail_unless(ids_s.dim() == 2 and ids_s.shape[0] == R,
                    f"K3 R=4: ids {tuple(ids_s.shape)}")
        got = sst.segment_stats_sorted(*a, with_spill=False)[:3]
        err = max(err, k3_check(a, got, "K3 R=4"))
        one = [(ids_s[r].contiguous(), *(x[:, r].contiguous()
                                         for x in (sv, mv, xv)), S)
               for r in range(R)]
        for r in range(R):
            s = sst.segment_stats_sorted(*one[r], with_spill=False)[:3]
            fail_unless(all(bitwise_equal(g[:, r], x)
                            for g, x in zip(got, s)),
                        f"K3 R=4: robot {r} differs from its single launch")
        lib_run, lib_results = k3_library(a)
        k3_check(a, lib_results(), "K3 R=4 yardstick (segment_reduce)")
        alone = [k3_kernel_only(x) for x in one]
        tt = in_turns({"kernel": k3_kernel_only(a),
                       "singles": lambda: [f() for f in alone]},
                      graph_ms, 50)
        tot["kernel"] += tt["kernel"]
        tot["singles"] += tt["singles"]
        tot["wrapper"] += cuda_ms(lambda: sst.segment_stats_sorted(
            *a, with_spill=False), 20)
        tot["plain"] += cuda_ms(lambda: sst.segment_stats_sorted_plain(*a),
                                5)
        tot["library"] += graph_ms(lib_run, 20)
        tot["bound"] += k3_bound(a)[0]
    print(f"phase 5 K3 R={R} (robot grid axis) calls=5 F="
          f"{[tuple(x.shape[0] for x in a[1:4]) for a in calls]}: ok "
          f"mins_maxs=bitwise robots_vs_single_launches=bitwise "
          f"sums_max_abs_err={err:.3g} per_frame_ms: "
          + " ".join(f"{k_}={v:.4f}" for k_, v in tot.items())
          + f" share_of_bound={tot['bound'] / tot['kernel']:.3f}",
          flush=True)
    out["segment_stats_sorted"] = (err, tot["kernel"] / 5, tot["plain"] / 5,
                                   (tot["bound"] / 5, "bytes"),
                                   tot["library"] / 5, tot["singles"] / 5)
    return out


def phase_backends(cfg, ms, batch):
    """The four fuse backends on one flagship frame.  pallas vs segment:
    the JAX suite's bounds (tests/test_fuse.py, rtol 3e-5 / atol 1e-5);
    stream vs segment: 5e-5 (phase 3's bound: per-cell f32 sums in another
    order); sort vs segment: 0.05 m and 2% of the variance, since its sums
    are a global f32 cumsum minus the carry at each run start and the
    prefix of 1/v over 131072 points reaches ~1e8 (an ULP of 8); colors
    equal everywhere; the `lowest` plane of the others (pointproc's
    `lowest_bound`) bitwise the stream fuse's."""
    from gem_tpu_torch.kernels.fuse import FUSE_BACKENDS, fuse

    out = {b: fuse(ms, cfg, batch, backend=b) for b in FUSE_BACKENDS}
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
    for b in ("segment", "sort", "pallas"):
        fail_unless(bool(torch.equal(out[b].lowest, out["stream"].lowest)),
                    f"backends: {b}'s lowest differs from the stream fuse's")
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
                         "--scan", "10", "--publish-submaps", p("records"),
                         "--save-octomap", p("x.npz")]) == 0,
                    "cli: kitti run failed")
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
          f"kitti/segment --scan 10 records={len(recs)} ortho={ortho.shape} "
          f"npz_levels={len(levels.files)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def octree_leaves(path):
    """Occupied leaves of a .bt or .ot file, read back by the port's reader."""
    from gem_tpu_torch.global_map import octomap_io

    read = octomap_io.read_bt if path.endswith(".bt") else octomap_io.read_ot
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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)
        with counted_launches() as counts:
            rc, out = run_cli(["run", "--device", dev.type, "--preset",
                               "kitti", "--frames", "40", "--speed", "1.0",
                               "--loop-demo", "--save-map", p("map.pcd"),
                               "--save-octomap", p("x.ot"), "--dense",
                               "--save-submaps", p("subs")])
        launches = counts["device"]
        fail_unless(rc == 0, "global-map cli: run failed")
        check_launches(counts, {"fuse_stream_aggregate": 40,
                                "plane_fit_features": 40,
                                "segment_stats_sorted": 0},
                       "global-map cli")
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


def k4_bytes(keys, rounds, valid, fused):
    """K4's least bytes over an event's rounds: each pair's two sorted key
    (int64) and source row (int32) columns, the a row's variance of each
    key the pair shares (the gate), and for each fused key the other three
    values read and both rows' z and variance written."""
    C = keys.shape[1]
    n_pairs = int(valid.sum())
    matched = 0
    for i, j in rounds[valid]:
        ka, kb = keys[int(i)], keys[int(j)]
        ends = torch.ones(C, dtype=torch.bool, device=keys.device)
        ends[:-1] = ka[1:] != ka[:-1]
        k = ka[ends & (ka < 0xFFFFFFFE)]
        q = torch.searchsorted(kb, k).clamp(max=C - 1)
        matched += int((kb[q] == k).sum())
    return n_pairs * 2 * C * 12 + matched * 4 + fused * 28


def phase_k4(dev):
    """Phase 14: K4 (`refuse_join`, csrc/refuse_join.cu), the re-stitch's
    pair join, at the flagship ring of phase 10 (64 x 32768, 512 pairs):
    `refuse_rounds` (keys sorted once, one K4 launch per round with a
    valid pair) against the plain per-round join on the card, bitwise in z,
    variance and the fused count, launches counted; then K4's ms per launch
    (the event's launches in one CUDA graph) beside its byte bound, the
    once-per-event key sort's ms, a plain round's ms (round 0 in one CUDA
    graph), both joins' event ms on the host clock, synchronised, in
    turns, and the host ms of the event's K4 dispatch: every round in one
    native call (`refuse_join_rounds`, as `refuse_rounds` makes it)
    against one `refuse_join` call per round with a pair (the per-round
    path), in turns, their launch counts equal.  Returns K4's row of the
    kernel table."""
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.global_map import loop_closure as lc
    from gem_tpu_torch.kernels.refuse_join import (refuse_join,
                                                   refuse_join_rounds)

    cfg = benchmark_config()
    K, C = cfg.submap.max_submaps, cfg.submap.capacity
    res = cfg.submap.dedup_cell_quantum or cfg.map.resolution
    store, poses = global_map_store(cfg, dev)
    slots = store.slots
    pairs = lc.select_pairs(poses[:, :2], cfg.submap.overlap_radius,
                            cfg.submap.max_pairs_per_submap)
    rounds, valid = lc.schedule_rounds(pairs)
    live = [rounds[r][valid[r]] for r in range(rounds.shape[0])
            if valid[r].any()]
    before = refuse_join.launches
    got, nf = lc.refuse_rounds(slots, rounds, valid, res)
    launches = refuse_join.launches - before
    want, wnf = lc.refuse_rounds_plain(slots, rounds, valid, res)
    fused = int(nf)
    fail_unless(fused == int(wnf) > K * C // 10 and launches == len(live),
                f"K4: fused {fused} vs plain {int(wnf)}, launches "
                f"{launches} for {len(live)} rounds")
    fail_unless(bitwise_equal(got.z, want.z)
                and bitwise_equal(got.variance, want.variance),
                "K4: z or variance differ from the plain join")

    keys, rows = lc._sorted_keys(slots, res)
    z, var = slots.z.clone(), slots.variance.clone()
    total = torch.zeros((), dtype=torch.int64, device=dev)

    def joins():
        for p in live:
            refuse_join(keys, rows, z, var, p, total)

    k4_ms = graph_ms(joins, 5) / len(live)
    b_ms, b_by = bound(k4_bytes(keys, rounds, valid, fused) / len(live))
    sort_ms = cuda_ms(lambda: lc._sorted_keys(slots, res), 10)

    rd = torch.as_tensor(rounds, device=dev).long()
    vd = torch.as_tensor(valid, device=dev)
    pad = lambda a: torch.cat([a, a.new_zeros((1, C))])
    zp, vp = pad(slots.z), pad(slots.variance)

    def plain_round():
        i, j, ok = rd[0, :, 0], rd[0, :, 1], vd[0]
        az, av, bz, bv, _ = lc._refuse(
            zp[i], vp[i], slots.x[i], slots.y[i], slots.valid[i],
            zp[j], vp[j], slots.x[j], slots.y[j], slots.valid[j], res)
        ti, tj = torch.where(ok, i, K), torch.where(ok, j, K)
        zp[ti], vp[ti] = az, av
        zp[tj], vp[tj] = bz, bv

    plain_ms = graph_ms(plain_round, 3)
    event = {"k4": [], "plain": []}
    for rep in range(6):
        for side in (("k4", "plain") if rep % 2 == 0 else ("plain", "k4")):
            fn = lc.refuse_rounds if side == "k4" else lc.refuse_rounds_plain
            torch.cuda.synchronize()
            event[side].append(timed(
                lambda: fn(slots, rounds, valid, res), True)[1])
    med = {k: statistics.median(v[1:]) for k, v in event.items()}

    def per_round():
        return sum(refuse_join(keys, rows, z, var, rounds[r][valid[r]], total)
                   for r in range(rounds.shape[0]) if valid[r].any())

    paths = {"one_call": lambda: refuse_join_rounds(
        keys, rows, z, var, rounds, valid, total), "per_round": per_round}
    dispatch = {k: [] for k in paths}
    counted = {}
    for rep in range(8):
        for side in (tuple(paths) if rep % 2 == 0 else tuple(paths)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counted[side] = paths[side]()
            dispatch[side].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    fail_unless(counted["one_call"] == counted["per_round"] == launches,
                f"K4 dispatch: {counted} launches, {launches} expected")
    d_med = {k: statistics.median(v[1:]) for k, v in dispatch.items()}
    print(f"phase 14 K4 refuse_join K={K} C={C} pairs={len(pairs)} rounds="
          f"{rounds.shape[0]} ({len(live)} with a pair) fused={fused}: ok "
          f"z_variance_count=bitwise launches={launches} kernel_ms_per_launch"
          f"={k4_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) share="
          f"{b_ms / k4_ms:.2f} key_sort_ms={sort_ms:.4f} plain_round_ms="
          f"{plain_ms:.4f} event_ms_median(host, synced) k4={med['k4']:.3f} "
          f"plain={med['plain']:.3f} dispatch_host_ms_median one_call="
          f"{d_med['one_call']:.4f} ({counted['one_call']} launches) "
          f"per_round={d_med['per_round']:.4f} ({counted['per_round']} "
          f"launches)", flush=True)
    return {"name": "refuse_join", "route": "cuda",
            "source": "gem_tpu_torch/csrc/refuse_join.cu",
            "replaces": "none: added for the re-stitch join",
            "launches": launches, "launches_per_event": launches,
            "max_abs_err": 0.0, "ms": k4_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "key_sort_ms": sort_ms, "event_ms": med["k4"],
            "plain_event_ms": med["plain"],
            "dispatch_host_ms": d_med["one_call"],
            "per_round_dispatch_host_ms": d_med["per_round"]}


def compact_inputs(lead, n, C, dev, seed):
    """(buf, count, new) on the card for K5: random fields (colors across
    int32 below 2^31 - 64), 60% of the inputs valid, half the buffer's
    rows valid, uneven counts (C // 3, 0, C - 5, C // 2 by row)."""
    from gem_tpu_torch.global_map.submaps import PointBuffer

    g = torch.Generator(device=dev).manual_seed(seed)
    R = int(np.prod(lead, dtype=np.int64))

    def points(m, frac):
        f = {k: torch.randn((R, m), generator=g, device=dev)
             for k in ("x", "y", "z", "variance", "intensity", "traver")}
        f["color"] = torch.randint(-2 ** 31, 2 ** 31 - 64, (R, m),
                                   generator=g, device=dev,
                                   dtype=torch.int32)
        f["valid"] = torch.rand((R, m), generator=g, device=dev) < frac
        return PointBuffer(**{k: v.reshape(lead + (m,))
                              for k, v in f.items()})

    count = torch.tensor([C // 3, 0, C - 5, C // 2][:R], dtype=torch.int32,
                         device=dev).reshape(lead)
    return points(C, 0.5), count, points(n, 0.6)


def compact_bytes(count, new, C, appended):
    """K5's least bytes: the inputs' valid flags (one byte each), the
    taken inputs' 28 bytes, the buffer's rows that stay (29 bytes each),
    every output row written (29 bytes), the counts read and written."""
    rows = count.numel()
    taken = int(appended.sum())
    return (new.valid.numel() + 28 * taken + 29 * (rows * C - taken)
            + 29 * rows * C + 12 * rows)


def compact_flat_cumsum(buf, count, new):
    """The plain compaction with the one change that needs no kernel: the
    ranks from one cumsum of every leading index's flags flattened (a 1-D
    tensor, which takes cub's device scan, where (rows, n) takes PyTorch's
    row scan, one block a row), each index's offset subtracted after.
    Bitwise `compact_append_plain`; timed beside K5."""
    from gem_tpu_torch.utils.tree import flat_rows

    C, n = buf.capacity, new.valid.shape[-1]
    flat = torch.cumsum(new.valid.reshape(-1), 0, dtype=torch.int32)
    ends = flat[n - 1::n]
    offset = torch.cat([ends.new_zeros(1), ends[:-1]])
    ranks = (flat.reshape(-1, n) - offset[:, None]).reshape(
        new.valid.shape)
    total = ranks[..., -1]
    appended = torch.clamp(torch.minimum(total, C - count), min=0)
    rank = torch.arange(C, dtype=torch.int32, device=ranks.device) \
        - count[..., None]
    take = (rank >= 0) & (rank < appended[..., None])
    src = flat_rows(torch.clamp(torch.searchsorted(ranks, rank + 1),
                                max=n - 1), n)
    pick = lambda f: torch.where(take, getattr(new, f).reshape(-1)[src],
                                 getattr(buf, f))
    out = type(buf)(
        x=pick("x"), y=pick("y"), z=pick("z"), variance=pick("variance"),
        intensity=pick("intensity"), traver=pick("traver"),
        color=pick("color").to(torch.float32).to(torch.int32),
        valid=take | buf.valid)
    return out, count + appended, total - appended


def phase_k5(dev):
    """Phase 15: K5 (`compact_append`, csrc/compact_append.cu), the submap
    store's compaction, at the main path's shapes: the fleet's masked
    keyframe finalize (4, L*L) and shed append (4, band), the single
    robot's finalize (L*L,) and staging flush (S * band,), into the
    flagship's 32768-row accumulator.  Each against the plain version on
    the card, bitwise in every field, the count and dropped, one launch
    counted per call; K5's ms (20 calls in one CUDA graph) beside its byte
    bound, the eager call's ms, and the ms (in one CUDA graph) of the
    plain version and of the plain version with one flat cumsum
    (`compact_flat_cumsum`, bitwise too).  Returns K5's row of the kernel
    table (the fleet finalize)."""
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.kernels.compact import (compact_append,
                                               compact_append_plain)

    cfg = benchmark_config()
    C, L = cfg.submap.capacity, cfg.map.length
    band = 2 * cfg.map.max_shift_cells * L
    shapes = [("fleet_finalize", (4,), L * L), ("fleet_shed", (4,), band),
              ("single_finalize", (), L * L),
              ("single_flush", (), cfg.submap.staging_frames * band)]
    rows = {}
    for seed, (name, lead, n) in enumerate(shapes, start=15):
        buf, count, new = compact_inputs(lead, n, C, dev, seed)
        before = compact_append.launches
        got = compact_append(buf, count, new)
        again = compact_append(buf, count, new)
        want = compact_append_plain(buf, count, new)
        flat = compact_flat_cumsum(buf, count, new)
        torch.cuda.synchronize()
        fail_unless(compact_append.launches - before == 2,
                    f"K5 {name}: {compact_append.launches - before} "
                    f"launches counted for 2 calls")
        for f in ("x", "y", "z", "variance", "intensity", "traver", "color",
                  "valid"):
            a, b, c, d = (getattr(o[0], f)
                          for o in (got, again, want, flat))
            eq = bitwise_equal if a.dtype == torch.float32 else torch.equal
            fail_unless(eq(a, c) and eq(a, b) and eq(d, c),
                        f"K5 {name}: {f} differs from the plain version "
                        f"or between two calls (or the flat cumsum's)")
        fail_unless(all(torch.equal(o[k], want[k]) for k in (1, 2)
                        for o in (got, flat)),
                    f"K5 {name}: count or dropped differ")
        appended = got[1] - count
        k5_ms = graph_ms(lambda: compact_append(buf, count, new), 20)
        eager_ms = cuda_ms(lambda: compact_append(buf, count, new), 20)
        plain_ms = graph_ms(lambda: compact_append_plain(buf, count, new), 5)
        flat_ms = graph_ms(lambda: compact_flat_cumsum(buf, count, new), 5)
        b_ms, b_by = bound(compact_bytes(count, new, C, appended))
        rows[name] = (k5_ms, b_ms, b_by, plain_ms, eager_ms, flat_ms)
        print(f"phase 15 K5 compact_append {name} lead={lead} n={n} C={C} "
              f"appended={appended.tolist()} dropped={got[2].tolist()}: ok "
              f"fields_count_dropped=bitwise kernel_ms={k5_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) share={b_ms / k5_ms:.2f} "
              f"eager_ms={eager_ms:.4f} plain_ms={plain_ms:.4f} "
              f"flat_cumsum_ms={flat_ms:.4f}", flush=True)
    k5_ms, b_ms, b_by, plain_ms, eager_ms, _ = rows["fleet_finalize"]
    return {"name": "compact_append", "route": "cuda",
            "source": "gem_tpu_torch/csrc/compact_append.cu",
            "replaces": "none: added for the submap compaction",
            "max_abs_err": 0.0, "ms": k5_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "eager_ms": eager_ms,
            "shapes": {k: {"ms": v[0], "bound_ms": v[1], "plain_ms": v[3],
                           "flat_cumsum_ms": v[5]}
                       for k, v in rows.items()}}


def single_pipelines(cfg, streams, dev, backend):
    """Each robot's frames through an ElevationPipeline of its own, with
    the fleet's config: the reference a fleet robot must equal."""
    from gem_tpu_torch.mapping.pipeline import ElevationPipeline
    from gem_tpu_torch.multirobot.fleet import fleet_effective_config

    states = []
    for frames in streams:
        pipe = ElevationPipeline(fleet_effective_config(cfg), device=dev,
                                 fuse_backend=backend)
        for f in frames:
            pipe.process(f)
        states.append(pipe.state)
    return states


def fleet_run(cfg, streams, dev, backend):
    """The streams through `FleetPipeline` (one CUDA graph per fleet
    frame), launches counted on the device.  Returns (fleet state, launch
    counts, per-frame ms, peak device memory)."""
    from gem_tpu_torch.multirobot.fleet import FleetPipeline, stack_frames

    R, T = len(streams), len(streams[0])
    stacked = [stack_frames([s[t] for s in streams]) for t in range(T)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with counted_launches() as counts:
        fleet = FleetPipeline(cfg, R, dev, fuse_backend=backend)
        for frames in stacked:
            t0 = time.perf_counter()
            fleet.process(frames)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return fleet.state, counts, times, torch.cuda.max_memory_allocated()


def fleet_equals_singles(fleet, singles, what):
    """Every leaf of each fleet robot bitwise its single pipeline's."""
    from gem_tpu_torch.utils.tree import tree_leaves, tree_map

    for r, single in enumerate(singles):
        a = tree_leaves(single)
        b = tree_leaves(tree_map(lambda x: x[r], fleet))
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        fail_unless(not bad, f"{what}: robot {r} differs from its single "
                    f"pipeline in {bad}")


def phase_fleet(dev, single=None):
    """Phase 11: four robots of the flagship (1000^2 cells, 131072-point
    frames with uneven point counts, 10 frames at 1.2-1.5 m per frame, so
    each robot passes the 10 m keyframe distance once) through
    `FleetPipeline` (one CUDA graph per fleet frame, one batched step over
    the robot axis) on the stream and on the pallas path, each robot
    bitwise a separate ElevationPipeline on its frames, each kernel
    launched once per fleet frame (K3 five times, K5 twice); then phase
    13's fleet
    check on the stream fleet's frames, beside `single`, phase 13's
    single-step numbers.  Returns ({backend: (fleet state, its config,
    launches, fleet-frame median)}, phase 13's fleet results)."""
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.io.replay import synthetic_frames

    R, T = 4, 10
    cfg = benchmark_config()
    n_pts = lambda r: 131072 - 16384 * r
    streams = [[f for f, _, _ in synthetic_frames(
        cfg, T, n_points=n_pts(r), speed=1.2 + 0.1 * r, seed=10 + r,
        device=dev)] for r in range(R)]
    out = {}
    for backend in ("stream", "pallas"):
        fleet, counts, times, peak = fleet_run(cfg, streams, dev, backend)
        launches = counts["device"]
        # K5 twice a fleet frame: the shed append, the masked finalize
        per = {"stream": (1, 1, 0, 2), "pallas": (0, 1, 5, 2)}[backend]
        check_launches(counts, {k: n * T for k, n in zip(
            ("fuse_stream_aggregate", "plane_fit_features",
             "segment_stats_sorted", "compact_append"), per)},
                       f"fleet {backend}")
        fleet_equals_singles(fleet, single_pipelines(cfg, streams, dev,
                                                     backend),
                             f"fleet {backend}")
        fused = (fleet.map.elevation != cfg.map.invalid_elevation).sum(
            dim=(-2, -1)).tolist()
        fail_unless(min(fused) > 0 and int(fleet.submaps.num_submaps.min())
                    >= 1, f"fleet {backend}: fused {fused}, submaps "
                    f"{fleet.submaps.num_submaps.tolist()}")
        med = statistics.median(times[1:])
        print(f"phase 11 fleet {backend} R={R} L={cfg.map.length} "
              f"P={cfg.max_points} points={[n_pts(r) for r in range(R)]} "
              f"{T} frames (FleetPipeline: one batched step, CUDA graph, "
              f"profiled): ok robots_vs_single_pipelines=bitwise "
              f"device_launches={launches} launches_per_fleet_frame="
              f"{ {k: v / T for k, v in launches.items()} } "
              f"fleet_frame_ms_median(2..{T})={med:.3f} "
              f"per_robot_ms={med / R:.3f} first_frame_ms={times[0]:.1f} "
              f"max_memory_allocated={peak} per_robot_fused_cells={fused} "
              f"num_submaps={fleet.submaps.num_submaps.tolist()} "
              f"dropped={fleet.submaps.dropped.tolist()}", flush=True)
        out[backend] = (fleet, cfg, launches, med)
    graph = phase_graph_fleet(dev, cfg, streams, single)
    del streams
    return out, graph


def phase_fleet_cli(dev):
    """Phase 11, the CLI: the README's loop-detect command on the card and
    on the CPU; the same loops and pairs."""
    cmd = ["fleet", "--robots", "2", "--frames", "80", "--world-seed", "3",
           "--drift-yaw", "8", "--drift-x", "1.0", "--loop-detect"]
    got = {}
    with tempfile.TemporaryDirectory() as d:
        for side in (dev.type, "cpu"):
            t0 = time.perf_counter()
            rc, out = run_cli([*cmd, "--device", side, "--publish-interpr",
                               os.path.join(d, f"{side}.npz")])
            dt = time.perf_counter() - t0
            fail_unless(rc == 0 and "fleet of 2 robots: 80 frames" in out,
                        f"fleet cli {side}: rc {rc}\n{out[-2000:]}")
            stats = json.loads(out.split("loop-detect: ")[1].splitlines()[0])
            got[side] = (stats, dt, out.split("per-robot fused cells: ")[1]
                         .splitlines()[0])
    (sd, td, fd), (sc, tc, fc) = got[dev.type], got["cpu"]
    fail_unless(sd["n_loops"] == sc["n_loops"] >= 1
                and sorted(map(tuple, sd["pairs"]))
                == sorted(map(tuple, sc["pairs"])),
                f"fleet cli: card {sd} vs cpu {sc}")
    print(f"phase 11 fleet cli loop-detect: ok card_s={td:.2f} cpu_s="
          f"{tc:.2f} fused card={fd} cpu={fc} card={json.dumps(sd)} "
          f"cpu={json.dumps(sc)}", flush=True)


def phase_distributed(dev, fleet, fleet_cfg):
    """Phase 12: an NCCL process group of one on the card.  The sharded loop
    closure at the flagship ring against the same call on a gloo CPU group;
    the sharded stencil at L=1000 against K2 on the card; a sharded
    checkpoint round trip of phase 11's fleet state.  A ring of several
    cards needs a machine with several cards."""
    import torch.distributed as dist

    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.global_map.sharded import (apply_sharded_loop_closure,
                                                  shard_store)
    from gem_tpu_torch.io.checkpoint import (load_checkpoint_sharded,
                                             save_checkpoint_sharded)
    from gem_tpu_torch.kernels import features as ft
    from gem_tpu_torch.multirobot import distributed as mdist
    from gem_tpu_torch.multirobot.spatial import (place_row_sharded,
                                                  sharded_features)
    from gem_tpu_torch.utils.tree import tree_leaves

    cfg = benchmark_config()
    K = cfg.submap.max_submaps
    res = cfg.map.resolution
    with tempfile.TemporaryDirectory() as d:
        mdist.initialize(os.path.join(d, "store"), 1, 0, backend="nccl")
        try:
            gloo = dist.new_group([0], backend="gloo")
            x = torch.arange(1 << 20, dtype=torch.float32, device=dev)
            fail_unless(bool(torch.equal(mdist.ring_shift(x), x)),
                        "distributed: world-1 ring_shift is not a copy")

            # --- sharded loop closure, NCCL on the card vs gloo on the CPU
            store_d, poses = global_map_store(cfg, dev)
            store_c, _ = global_map_store(cfg, torch.device("cpu"))
            rng = np.random.default_rng(1)
            opt = poses.copy()
            opt[1:, :2] += res * rng.integers(-3, 4, (K - 1, 2))
            apply_sharded_loop_closure(shard_store(store_d), cfg, opt)
            (new_d, st_d), lc_ms = timed(lambda: apply_sharded_loop_closure(
                shard_store(store_d), cfg, opt), True)
            (new_c, st_c), lc_cpu_ms = timed(
                lambda: apply_sharded_loop_closure(shard_store(store_c, gloo),
                                                   cfg, opt, gloo), False)
            fail_unless(st_d == st_c and st_d["n_corrected"] == K
                        and st_d["n_cells_fused"] > 0,
                        f"sharded loop closure: stats {st_d} vs {st_c}")
            lc_err = {k: float((getattr(new_d.slots, k).cpu()
                                - getattr(new_c.slots, k)).abs().max())
                      for k in ("x", "y", "z", "variance")}
            fail_unless(lc_err["x"] == 0.0 and lc_err["y"] == 0.0
                        and lc_err["z"] <= 1e-5
                        and lc_err["variance"] <= 1e-5,
                        f"sharded loop closure: card vs cpu {lc_err}")

            # --- halo stencil at L=1000 vs K2 (geographic plane, start 0)
            m = terrain_map(cfg, dev)
            holes = torch.from_numpy(np.random.default_rng(12).random(
                m.elevation.shape) < 0.2).to(dev)
            m = m.replace(start=torch.zeros_like(m.start),
                          elevation=torch.where(holes, -10.0, m.elevation))
            fn = sharded_features(cfg.map)
            plane = place_row_sharded(m.elevation)
            sh = fn(plane)
            k2 = ft.plane_fit_features(m, cfg.map)
            torch.cuda.synchronize()
            st_err = {k: float((a - getattr(k2, k)).abs().max())
                      for k, a in zip(("slope", "rough", "traver"), sh)}
            fail_unless(max(st_err.values()) <= 1e-5,
                        f"sharded stencil vs K2: {st_err}")
            st_ms = cuda_ms(lambda: fn(plane), 5)
            k2_ms = cuda_ms(lambda: ft.plane_fit_features(m, cfg.map), 20)

            # --- sharded checkpoint of phase 11's fleet
            R = fleet.frame_idx.shape[0]
            ck = os.path.join(d, "ck")
            _, save_ms = timed(lambda: save_checkpoint_sharded(ck, fleet),
                               True)
            back, load_ms = timed(lambda: load_checkpoint_sharded(
                ck, fleet_cfg, range(R), device=dev), True)
            a, b = tree_leaves(fleet), tree_leaves(back)
            bad = [k for k in a if not torch.equal(a[k], b[k])]
            fail_unless(not bad, f"sharded checkpoint: {bad} differ")
            nbytes = sum(v.numel() * v.element_size() for v in a.values())
        finally:
            mdist.shutdown()
    print(f"phase 12 distributed nccl world=1 (a multi-card ring needs "
          f"several cards: not run on this one-card machine): ok "
          f"sharded_loop_closure K={K} stats={json.dumps(st_d)} "
          f"card_vs_gloo_cpu_max_abs_err={lc_err} ms={lc_ms:.3f} "
          f"gloo_cpu_ms={lc_cpu_ms:.3f}; halo_stencil L={cfg.map.length} "
          f"vs K2 max_abs_err={st_err} ms={st_ms:.4f} k2_eager_ms="
          f"{k2_ms:.4f}; checkpoint R={R} bytes={nbytes} bitwise "
          f"save_ms={save_ms:.1f} load_ms={load_ms:.1f}", flush=True)


def kernel_wrappers():
    """Every kernel wrapper of the port, by name: each counts its launches
    in `.launches`."""
    from gem_tpu_torch.kernels.compact import compact_append
    from gem_tpu_torch.kernels.features import plane_fit_features
    from gem_tpu_torch.kernels.fuse_stream import fuse_stream_aggregate
    from gem_tpu_torch.kernels.segment_stats import segment_stats_sorted

    return {"fuse_stream_aggregate": fuse_stream_aggregate,
            "plane_fit_features": plane_fit_features,
            "segment_stats_sorted": segment_stats_sorted,
            "compact_append": compact_append}


# each wrapper's kernel, by the symbol the profiler names its launches with
# (K5's second kernel: one a call)
KERNEL_SYMBOLS = {"fuse_stream_aggregate": "fuse_stream_aggregate_kernel",
                  "plane_fit_features": "plane_fit_kernel",
                  "segment_stats_sorted": "segment_stats_kernel",
                  "compact_append": "compact_scatter_kernel"}


def device_events(prof):
    """The CUDA-side events of a torch.profiler run: kernels, copies and
    fills, each with its name and time range (us)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@contextlib.contextmanager
def counted_launches():
    """Count each kernel's launches on the device inside the block.  A
    replayed CUDA graph launches its kernels without calling the wrappers,
    so the counts come from torch.profiler's CUDA kernel events, by the
    kernels' own symbols.  The wrappers' counts are set to 0 just before
    too; they then count the eager first frame and the captures.  Yields a
    dict that is filled on exit: {"device": {name: n}, "wrapper": {name:
    n}}."""
    from torch.profiler import ProfilerActivity, profile

    wrappers = kernel_wrappers()
    counts = {}
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # let the tracer come up before the counted work starts (one run's
        # fleet count came out one kernel short without this wait)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        time.sleep(0.05)
        yield counts
        torch.cuda.synchronize()
    names = [e.name for e in device_events(prof)]
    counts["device"] = {k: sum(sym in n for n in names)
                        for k, sym in KERNEL_SYMBOLS.items()}
    counts["wrapper"] = {k: w.launches for k, w in wrappers.items()}


def check_launches(counts, want, what):
    """The device counts of the kernels in `want` ({name: n}) equal it;
    every wrapper of a kernel the path launches was called (eager first
    frame, capture), and no other of them."""
    got = {k: counts["device"][k] for k in want}
    fail_unless(got == want, f"{what}: device launch counts {got}, "
                f"expected {want}")
    fail_unless(all((counts["wrapper"][k] > 0) == (n > 0)
                    for k, n in want.items()),
                f"{what}: wrapper calls {counts['wrapper']} for {want}")


def phase_flagship(dev, backend, frames, world):
    """30 flagship frames through ElevationPipeline with `backend`; every
    launch count is set to 0 just before and read just after.  Returns
    (launches by kernel, median step ms, the global cloud, the final map)."""
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
    expect = {k: n * n_frames for k, n in expect.items()}
    S = cfg.submap.staging_frames
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, sheds, fused, bodies = [], [], [], []
    with counted_launches() as counts:
        pipe = ElevationPipeline(cfg, device=dev, fuse_backend=backend)
        for f in frames:
            used = int(pipe.state.submaps.staging_used)
            t0 = time.perf_counter()
            out = pipe.process(f)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            sheds.append(int(out.metrics["shed_count"]))
            fused.append(int(out.metrics["cells_fused"]))
            bodies.append((used + 1 >= S, bool(out.keyframe_due.any())))
    launches = counts["device"]
    st = pipe.state
    # K5: the eager first frame runs the flush's and the finalize's masked
    # bodies (1 + 2 calls); a replay only the taken ones, a flush body one
    # call, a finalize body two (its staged flush, the grid snapshot)
    expect["compact_append"] = 3 + sum(fl + 2 * kf for fl, kf in bodies[1:])
    check_launches(counts, expect, f"flagship {backend}")
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
          f"{n_frames} frames (ElevationPipeline: CUDA graph, profiled): ok "
          f"step_ms_median(5..30)={step_ms:.3f} "
          f"step_ms_min={min(times[5:]):.3f} first_frame_ms={times[0]:.1f} "
          f"cells_fused={fused[-1]} shed_frames={sum(s > 0 for s in sheds)} "
          f"num_submaps={int(st.submaps.num_submaps)} taken_bodies(flush, "
          f"finalize)={tuple(map(sum, zip(*bodies[1:])))} "
          f"rmse_vs_truth={rmse:.5f}"
          f" median_abs_err={med:.5f} device_launches={launches} "
          f"wrapper_calls={counts['wrapper']} "
          f"max_memory_allocated={peak}", flush=True)
    return launches, step_ms, cloud, st.map


@contextlib.contextmanager
def sync_free():
    """`torch.cuda.set_sync_debug_mode("error")` inside the block: any
    synchronising operation (a host read, a blocking upload) raises."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def differing_leaves(a, b):
    """The leaves of two trees that are not bitwise equal (type included)."""
    from gem_tpu_torch.utils.tree import tree_leaves

    a, b = tree_leaves(a), tree_leaves(b)
    fail_unless(a.keys() == b.keys(), "graph vs eager: other leaves")
    raw = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return [k for k in a if a[k].dtype != b[k].dtype
            or a[k].shape != b[k].shape
            or not torch.equal(raw(a[k]), raw(b[k]))]


def with_jump(frames, at):
    """The frames with a loop closure at frame `at`: the pose jumps 0.5 m
    and 0.3 m up there and stays so (the jump settles and finishes)."""
    import dataclasses

    out = list(frames)
    shift = torch.tensor([0.5, 0.0, 0.3], device=frames[0].points.device)
    for i in range(at, len(out)):
        out[i] = dataclasses.replace(
            out[i], track_position=out[i].track_position + shift)
    out[at] = dataclasses.replace(out[at], loop_closure=torch.ones(
        (), dtype=torch.bool, device=shift.device))
    return out


def busy_share(prof, wall_s):
    """(union of the device events' time over `wall_s`, device events, the
    sum of their durations in ms)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events(prof))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / (wall_s * 1e6), len(spans), sum(b - a for a, b in
                                                  spans) / 1e3


def profiled_drive(run_frame, frames, lo=20):
    """Frames through `run_frame`, synced after each; frames lo..end under
    torch.profiler (CUDA events only).  Returns (busy share over those
    frames, device events per frame, device ms per frame, peak device
    memory the drive added)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for f in frames[:lo]:
        run_frame(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[lo:]:
            run_frame(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    share, n_ev, dev_ms = busy_share(prof, wall)
    n = len(frames) - lo
    return share, n_ev / n, dev_ms / n, torch.cuda.max_memory_allocated() \
        - base


def graphs_in_turns(fns, reps=20, rounds=6):
    """{name: median ms per call} of each closure: one eager call, then
    `reps` calls captured in one CUDA graph each; the graphs replayed in
    turns (order reversed every round) under CUDA events."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        graphs[name] = g
    torch.cuda.synchronize()
    times = {k: [] for k in graphs}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for r in range(rounds):
        for k in (list(graphs) if r % 2 == 0 else list(graphs)[::-1]):
            t0.record()
            graphs[k].replay()
            t1.record()
            torch.cuda.synchronize()
            times[k].append(t0.elapsed_time(t1) / reps)
    return {k: statistics.median(v) for k, v in times.items()}


def branch_costs_ms(cfg, state, frame):
    """Device ms per call (a CUDA graph of 20 calls, the graphs timed in
    turns) of what a frame pays for a branch it does not take, at
    `state`.  As IF nodes (the graph
    route of utils/control.py, what the step captures now): the jump
    cond's cost on a move frame (its graph less the move's alone), an
    untaken staging flush, an untaken keyframe finalize with its grid
    snapshot; `move` is the move alone.  As the select route's masked
    forms, which run both sides: re_anchor
    and the select of its planes against the move's, the masked flush,
    the masked finalize.  With a False predicate each leaves the store
    as it was, so the calls repeat."""
    from gem_tpu_torch.core.move import empty_shed, move, re_anchor
    from gem_tpu_torch.global_map import submaps as sm
    from gem_tpu_torch.utils import control
    from gem_tpu_torch.utils.tree import tree_select

    dev = frame.points.device
    no = torch.zeros((), dtype=torch.bool, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    track = frame.track_position
    ms, store = state.map, state.submaps
    moved, _ = move(ms, cfg.map, track)
    pose = torch.cat([track, frame.pose_quat])

    def move_side(m):
        new, info = move(m, cfg.map, track)
        return new, info.shed, info.index_shift

    def jump_side(m):
        return (re_anchor(m, cfg.map, track, track[2] - state.last_track_z),
                empty_shed(cfg, dev), torch.zeros(2, dtype=torch.int32,
                                                  device=dev))

    def finalize(store, when=None):
        return sm.finalize_submap(store, sm.grid_to_points(ms, cfg,
                                                           ms.traver),
                                  pose, when=when)

    ms_ = graphs_in_turns({
        "move": lambda: move_side(ms),
        "jump_cond": lambda: control.cond(yes, move_side, jump_side, ms),
        "if_staging_flush": lambda: control.when(no, sm.flush_staging,
                                                 store),
        "if_keyframe_finalize": lambda: control.when(no, finalize, store),
        "masked_jump_select": lambda: tree_select(no, re_anchor(
            ms, cfg.map, track, track[2] - state.last_track_z), moved),
        "masked_staging_flush": lambda: sm.flush_staging(store, no),
        "masked_keyframe_finalize": lambda: finalize(store, no)})
    ms_["if_jump"] = ms_.pop("jump_cond") - ms_["move"]
    return ms_


def phase_graph(dev, frames):
    """Phase 13: the step as CUDA graphs against the eager `step` loop, at
    the flagship (phase 8's 30 frames, frame 12 closing a loop, one
    keyframe), for both paths:
      * every frame through `ElevationPipeline.process` under
        set_sync_debug_mode("error") and through eager `step` (also under
        it), in turns; every state leaf and every output bitwise equal
        after every frame (the jump frame replays the graph captured on
        frame 0: frames always carry `loop_closure`); the median step of
        each over frames 5-29;
      * the cost of copying a frame's outputs out of the graph, as a
        replay does, and the device time of an untaken branch
        (`branch_costs_ms`);
      * each alone on fresh state, frames 20-29 under torch.profiler:
        device-busy share of wall time, device events and device ms per
        frame, and the peak memory each drive adds;
      * `ElevationPipeline.scan_steps` (T=10, one graph of 10 steps) on
        frames 0-9 and then 10-19 against 20 eager steps, bitwise, with
        the per-frame time of the second call (a replay).
    Returns {backend: (graph median ms, eager median ms, graph profile,
    eager profile)}, a profile as `profiled_drive` returns it."""
    from gem_tpu_torch.config import benchmark_config
    from gem_tpu_torch.mapping.pipeline import (ElevationPipeline,
                                                init_pipeline_state, step)
    from gem_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = benchmark_config()
    jumped = with_jump(frames, 12)
    out = {}
    for backend in ("stream", "pallas"):
        t0 = time.perf_counter()
        pipe = ElevationPipeline(cfg, device=dev, fuse_backend=backend)
        state = init_pipeline_state(cfg, dev)
        t_graph, t_eager, jumps, keyframes = [], [], 0, 0
        for i, f in enumerate(jumped):
            for side in ((0, 1) if i % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with sync_free():
                    if side == 0:
                        got = pipe.process(f)
                    else:
                        state, ref = step(state, f, cfg, backend)
                torch.cuda.synchronize()
                (t_graph if side == 0 else t_eager).append(
                    (time.perf_counter() - t1) * 1e3)
            bad = differing_leaves(pipe.state, state) \
                + differing_leaves(got, ref)
            fail_unless(not bad, f"graph {backend} frame {i}: {bad} differ "
                        f"from the eager step")
            jumps += bool(state.jump_odom)
            keyframes += bool(ref.keyframe_due)
        fail_unless(jumps > 0 and keyframes > 0,
                    f"graph {backend}: jump frames {jumps}, keyframes "
                    f"{keyframes}")
        g_ms = statistics.median(t_graph[5:])
        e_ms = statistics.median(t_eager[5:])
        copy_ms = cuda_ms(lambda: tree_map(torch.clone, got), 20)
        out_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(got).values())
        costs = branch_costs_ms(cfg, state, jumped[-1])
        del pipe, state, got, ref

        held = {}

        def graph_frame(f):
            if "pipe" not in held:
                held["pipe"] = ElevationPipeline(cfg, device=dev,
                                                 fuse_backend=backend)
            held["pipe"].process(f)

        def eager_frame(f):
            if "state" not in held:
                held["state"] = init_pipeline_state(cfg, dev)
            held["state"], _ = step(held["state"], f, cfg, backend)

        g_busy = profiled_drive(graph_frame, jumped)
        held.clear()
        e_busy = profiled_drive(eager_frame, jumped)
        held.clear()

        # scan_steps: T=10 in one graph, twice, against 20 eager steps
        pipe = ElevationPipeline(cfg, device=dev, fuse_backend=backend)
        state = init_pipeline_state(cfg, dev)
        for lo in (0, 10):
            chunk = frames[lo:lo + 10]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with sync_free():
                m = pipe.scan_steps(chunk)
            torch.cuda.synchronize()
            scan_ms = (time.perf_counter() - t1) * 1e3 / 10
            t1 = time.perf_counter()
            rows = []
            for f in chunk:
                state, ref = step(state, f, cfg, backend)
                rows.append(ref.metrics["cells_fused"])
            torch.cuda.synchronize()
            loop_ms = (time.perf_counter() - t1) * 1e3 / 10
            bad = differing_leaves(pipe.state, state)
            fail_unless(not bad and bitwise_equal(m["cells_fused"],
                                                  torch.stack(rows)),
                        f"scan_steps {backend} frames {lo}-{lo + 9}: {bad}")
        del pipe, state
        print(f"phase 13 graph {backend} L={cfg.map.length} P="
              f"{cfg.max_points} {len(jumped)} frames (jump at 12, "
              f"{keyframes} keyframes): ok graph_vs_eager=bitwise every "
              f"frame, state and outputs; sync_debug=error "
              f"step_ms_median(5..29) graph={g_ms:.3f} eager="
              f"{e_ms:.3f} first_frame_ms graph={t_graph[0]:.1f} eager="
              f"{t_eager[0]:.1f} output_copy_ms={copy_ms:.4f} "
              f"({out_bytes} bytes) untaken_branch_device_ms="
              f"{json.dumps({k: round(v, 4) for k, v in costs.items()})} "
              f"profile(frames 20..29) graph: busy_share={g_busy[0]:.4f} "
              f"device_events_per_frame={g_busy[1]:.1f} device_ms_per_frame="
              f"{g_busy[2]:.3f} peak_bytes={g_busy[3]}; eager: busy_share="
              f"{e_busy[0]:.4f} device_events_per_frame={e_busy[1]:.1f} "
              f"device_ms_per_frame={e_busy[2]:.3f} peak_bytes={e_busy[3]}; "
              f"scan_steps T=10 frames 0-19 bitwise, replay ms_per_frame="
              f"{scan_ms:.3f} eager_loop ms_per_frame={loop_ms:.3f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        out[backend] = (g_ms, e_ms, g_busy, e_busy)
    return out


def phase_cond_route(dev):
    """Phase 13, the conditional-node route of utils/control.py: torch's
    version and whether it binds `begin_capture_to_if_node` (this package
    does not need it: csrc/graph_cond.cu makes the IF nodes); a cond (with
    a merge fixup) and a when captured into one graph, its nodes counted,
    replayed with the predicate True and False against the eager calls."""
    from gem_tpu_torch.utils import control

    a = torch.arange(8.0, device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    store = {"n": torch.zeros((), dtype=torch.int32, device=dev)}
    # the true side returns its operand: the merge needs a third IF node
    sides = (lambda v: (v * 2, v), lambda v: (v * 3, torch.cumsum(v, 0)))

    def bump(s, when=None):
        control.assign(when, s["n"], s["n"] + 1)
        return s

    control.cond(pred, *sides, a)          # the eager warm-up
    control.when(pred, bump, store)
    torch.cuda.synchronize()
    control.IF_NODES.clear()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, pool=torch.cuda.graph_pool_handle()):
        got = tuple(t + 0 for t in control.cond(pred, *sides, a))
        control.when(pred, bump, store)
    nodes = control.count_graph_nodes(g)
    bodies = list(control.IF_NODES)
    n = 0
    for p in (True, False, True):
        pred.fill_(p)
        g.replay()
        n += p
        want = sides[0](a) if p else sides[1](a)
        fail_unless(all(bitwise_equal(x, y) for x, y in zip(got, want))
                    and int(store["n"]) == n,
                    f"cond route: replay with pred {p} wrong")
    fail_unless(nodes[1] == 4, f"cond route: {nodes} (all, conditional, "
                f"work) nodes, expected 4 conditional")
    print(f"phase 13 cond route: ok torch {torch.__version__} binds "
          f"begin_capture_to_if_node: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}; "
          f"csrc/graph_cond.cu IF nodes: cond + when captured "
          f"(nodes, conditional, work at top level)={nodes} bodies={bodies},"
          f" replays True/False/True bitwise the eager calls", flush=True)


MARKER = "spin_kernel"   # torch.cuda._sleep's kernel: cuts a trace


def per_frame_device(run_frame, frames):
    """(device events, device ms) of each frame but the first: `run_frame`
    over `frames` under one torch.profiler run, each frame followed by a
    marker kernel (torch.cuda._sleep) and a sync, the device events cut at
    the markers.  The first frame only brings the tracer up (one run's
    first traced frame came out one event short)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        time.sleep(0.05)
        run_frame(frames[0])
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        for f in frames[1:]:
            run_frame(f)
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
    events = sorted(device_events(prof), key=lambda e: e.time_range.start)
    cuts = [i for i, e in enumerate(events) if MARKER in e.name]
    fail_unless(len(cuts) == len(frames),
                f"per-frame profile: {len(cuts)} markers for "
                f"{len(frames) - 1} frames")
    return [(b - a - 1, sum(e.time_range.end - e.time_range.start
                            for e in events[a + 1:b]) / 1e3)
            for a, b in zip(cuts, cuts[1:])]


def branch_drive(dev, cfg, frames, what):
    """Phase 13: `frames` through ElevationPipeline (the graph: a single
    robot's branches as IF nodes) and the eager `step` (every branch a
    select), in turns under set_sync_debug_mode("error"), every state leaf
    and output bitwise after every frame, noting the branches each frame
    takes.  Then a fresh pipeline over the same frames: its capture's IF
    nodes (`control.IF_NODES`: each body's kernel, copy and fill nodes)
    and the device events and ms of each replayed frame from the third on;
    every such frame's events less its taken bodies' nodes must be one
    number.  Returns the summary
    it prints."""
    from gem_tpu_torch.mapping.pipeline import (ElevationPipeline,
                                                init_pipeline_state, step)
    from gem_tpu_torch.utils import control

    every, S = cfg.raytrace_every, cfg.submap.staging_frames
    pipe = ElevationPipeline(cfg, device=dev)
    state = init_pipeline_state(cfg, dev)
    taken = []
    for i, f in enumerate(frames):
        due = every > 1 and int(state.frame_idx) % every == 0
        full = S > 0 and int(state.submaps.staging_used) == S - 1
        with sync_free():
            got = pipe.process(f)
            state, ref = step(state, f, cfg)
        bad = differing_leaves(pipe.state, state) + differing_leaves(got, ref)
        fail_unless(not bad, f"branches {what} frame {i}: {bad} differ from "
                    f"the eager step")
        jump, key = bool(state.jump_odom), bool(ref.keyframe_due)
        taken.append({"_move_branch": not jump, "_jump_branch": jump,
                      "_raytrace": due, "_unchanged": every > 1 and not due,
                      "flush_staging": full, "_finalize": key})
    del pipe, state, got, ref

    held = {}
    control.IF_NODES.clear()
    held["pipe"] = ElevationPipeline(cfg, device=dev)
    held["pipe"].process(frames[0])
    bodies = list(control.IF_NODES)
    want = ["_move_branch", "_jump_branch"] + ["flush_staging"] * (S > 0) \
        + ["_raytrace", "_unchanged"] * (every > 1) + ["_finalize"]
    fail_unless([name for name, _ in bodies] == want,
                f"branches {what}: IF nodes {bodies}, expected {want}")
    count = {k: sum(t[k] for t in taken) for k in taken[0]}
    # frame 0 captured, frame 1 brings the tracer up: frames 2.. profiled
    rows = per_frame_device(lambda f: held["pipe"].process(f), frames[1:])
    held.clear()
    taken = taken[2:]
    base = [n - sum(w for name, w in bodies if taken[i][name])
            for i, (n, _) in enumerate(rows)]
    fail_unless(len(set(base)) == 1, f"branches {what}: device events less "
                f"the taken bodies' nodes differ by frame: {base}; events "
                f"{[n for n, _ in rows]}; bodies {bodies}")
    plain = lambda t: not (t["_jump_branch"] or t["_raytrace"]
                           or t["flush_staging"] or t["_finalize"])
    split = {}
    for label, pick in (("no_branch", plain),
                        ("branch", lambda t: not plain(t))):
        sel = [r for r, t in zip(rows, taken) if pick(t)]
        if sel:
            split[label] = {"frames": len(sel),
                            "device_events": statistics.mean(
                                n for n, _ in sel),
                            "device_ms": statistics.mean(m for _, m in sel)}
    summary = {"jump_frames": count["_jump_branch"],
               "keyframes": count["_finalize"],
               "staging_flushes": count["flush_staging"],
               "raytrace_frames": count["_raytrace"] if every > 1
               else len(frames), "bodies": bodies,
               "events_outside_bodies": base[0], **split}
    print(f"phase 13 branches {what} L={cfg.map.length} P={cfg.max_points} "
          f"raytrace_every={every} staging_frames={S} keyframe_distance="
          f"{cfg.submap.keyframe_distance} store_ortho="
          f"{cfg.submap.store_ortho} keyframe_scan_points="
          f"{cfg.submap.keyframe_scan_points} {len(frames)} frames: ok "
          f"graph_vs_eager=bitwise every frame, sync_debug=error; every "
          f"frame's device events = {base[0]} + its taken IF bodies' nodes; "
          f"{json.dumps(summary)}", flush=True)
    return summary


def phase_branches(dev, frames):
    """Phase 13's branch drives: the benchmark preset on phase 8's frames
    with a jump at 12 (the prediction's untaken frames), the flagship
    width with every branch taken, and the kitti preset, `run`'s
    default, with its orthomosaic and keyframe scan stored."""
    import dataclasses

    from gem_tpu_torch.config import benchmark_config, kitti_config
    from gem_tpu_torch.io.replay import synthetic_frames

    jumped = with_jump(frames, 12)
    out = {"benchmark": branch_drive(dev, benchmark_config(), jumped,
                                     "benchmark")}
    cfg = benchmark_config(raytrace_every=3)
    cfg = cfg.replace(submap=dataclasses.replace(
        cfg.submap, keyframe_distance=4.0, staging_frames=8))
    out["every_branch"] = branch_drive(dev, cfg, jumped, "every_branch")
    fail_unless(all(out["every_branch"][k] > 0 for k in (
        "jump_frames", "keyframes", "staging_flushes", "raytrace_frames")),
        f"every_branch: {out['every_branch']}")
    kitti = kitti_config()
    kframes = with_jump([f for f, _, _ in synthetic_frames(
        kitti, 40, speed=1.0, seed=3, device=dev)], 20)
    out["kitti"] = branch_drive(dev, kitti, kframes, "kitti")
    return out


def phase_graph_fleet(dev, cfg, streams, single=None):
    """Phase 13, the fleet: phase 11's four flagship robots through
    `FleetPipeline` (one CUDA graph per fleet frame) under
    set_sync_debug_mode("error") and through eager `fleet_step`, in turns;
    state and outputs bitwise after every frame, the fleet-frame median of
    each over frames 2-10.  Then each alone on fresh state, fleet frames
    5-9 under torch.profiler: device events and device ms per fleet frame,
    device-busy share, peak memory added, printed beside `single` (phase
    13's graph and eager single-step results, stream).  Returns (graph ms,
    eager ms, graph profile, eager profile)."""
    from gem_tpu_torch.multirobot.fleet import (FleetPipeline, fleet_step,
                                                make_fleet_state,
                                                stack_frames)

    R, T = len(streams), len(streams[0])
    stacked = [stack_frames([s[t] for s in streams]) for t in range(T)]
    fleet = FleetPipeline(cfg, R, dev)
    ref = make_fleet_state(cfg, R, dev)
    t_graph, t_eager = [], []
    for t, frames in enumerate(stacked):
        for side in ((0, 1) if t % 2 == 0 else (1, 0)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if side == 0:
                with sync_free():
                    got = fleet.process(frames)
            else:
                ref, want = fleet_step(ref, frames, cfg)
            torch.cuda.synchronize()
            (t_graph if side == 0 else t_eager).append(
                (time.perf_counter() - t1) * 1e3)
        bad = differing_leaves(fleet.state, ref) + differing_leaves(got, want)
        fail_unless(not bad, f"graph fleet frame {t}: {bad} differ")
    g_ms, e_ms = statistics.median(t_graph[1:]), statistics.median(
        t_eager[1:])
    del fleet, ref, got, want

    held = {}

    def graph_frame(f):
        if "pipe" not in held:
            held["pipe"] = FleetPipeline(cfg, R, dev)
        held["pipe"].process(f)

    def eager_frame(f):
        if "state" not in held:
            held["state"] = make_fleet_state(cfg, R, dev)
        held["state"], _ = fleet_step(held["state"], f, cfg)

    g_prof = profiled_drive(graph_frame, stacked, lo=5)
    held.clear()
    e_prof = profiled_drive(eager_frame, stacked, lo=5)
    held.clear()
    prof = lambda p: (f"busy_share={p[0]:.4f} device_events_per_frame="
                      f"{p[1]:.1f} device_ms_per_frame={p[2]:.3f} "
                      f"peak_bytes={p[3]}")
    beside = ""
    if single is not None:
        beside = (f"; single step (phase 13, stream, frames 20..29) graph: "
                  f"{prof(single[2])}; eager: {prof(single[3])}")
    print(f"phase 13 graph fleet stream R={R} L={cfg.map.length} {T} frames "
          f"(one batched step): ok graph_vs_eager_fleet_step=bitwise every "
          f"frame; sync_debug=error fleet_frame_ms_median(2..{T}) graph="
          f"{g_ms:.3f} eager={e_ms:.3f} first_frame_ms graph="
          f"{t_graph[0]:.1f} eager={t_eager[0]:.1f} profile(fleet frames "
          f"5..{T - 1}) graph: {prof(g_prof)}; eager: {prof(e_prof)}"
          f"{beside}", flush=True)
    return g_ms, e_ms, g_prof, e_prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", metavar="DIR",
                    help="also time the earlier fuse_stream.cu, "
                         "features.cu and segment_stats.cu in DIR, those "
                         "it holds (phases 3, 4 and 5)")
    args = ap.parse_args()
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
    old = Earlier(args.old) if args.old else None
    k1, prior = phase_k1(benchmark_config, dev, old)
    k3, k3_adv_err, flagship_frame = phase_k3(benchmark_config, dev, old)
    robots = phase_robot_axis(benchmark_config, dev)
    phase_backends(*flagship_frame)
    del flagship_frame
    phase_parity(dev, "stream")
    phase_parity(dev, "pallas")
    frames, world = [], None
    for f, _, world in synthetic_frames(benchmark_config(), 30,
                                        n_points=131072, speed=0.5, seed=0,
                                        device=dev):
        frames.append(f)
    launches, step_stream, cloud, stream_map = phase_flagship(
        dev, "stream", frames, world)
    launches_pallas, step_pallas, _, _ = phase_flagship(dev, "pallas", frames,
                                                        world)
    graph_ms = phase_graph(dev, frames)
    phase_cond_route(dev)
    branches = phase_branches(dev, frames)
    del frames
    # phase 4 after the flagship: its second state is the stream path's map
    cfg = benchmark_config()
    k2 = phase_k2(cfg, {"phase3_prior": prior, "stream_30_frames": stream_map,
                        "valid_terrain": terrain_map(cfg, dev)}, old)
    del prior, stream_map
    phase_cli(dev)
    phase_global_map_cli(dev)
    phase_global_map(dev, cloud)
    del cloud
    k4 = phase_k4(dev)
    k5 = phase_k5(dev)
    fleets, fleet_graph = phase_fleet(dev, graph_ms["stream"])
    phase_fleet_cli(dev)
    phase_distributed(dev, *fleets["stream"][:2])
    fleet_launches = {**fleets["stream"][2], "segment_stats_sorted":
                      fleets["pallas"][2]["segment_stats_sorted"]}
    fleet_ms = {k: v[3] for k, v in fleets.items()}
    del fleets

    n_frames = 30
    k1_main = next(r for r in k1 if r[0] == "131k")
    k2_main = k2["stream_30_frames"]
    k3_err, k3_main = k3["131k"]
    kernels = [
        {"name": "fuse_stream_aggregate", "route": "cuda",
         "source": "gem_tpu_torch/csrc/fuse_stream.cu",
         "replaces": "gem_tpu/kernels/fuse_stream.py:521, :213, :757",
         "launches": launches["fuse_stream_aggregate"],
         "launches_per_frame": launches["fuse_stream_aggregate"] / n_frames,
         "fleet_launches": fleet_launches["fuse_stream_aggregate"],
         "max_abs_err": max(r[1] for r in k1),
         "ms": k1_main[2], "plain_ms": k1_main[3],
         "bound_ms": k1_main[4][0], "bound_by": k1_main[4][1],
         "library_ms": None, "eager_ms": k1_main[5]},
        {"name": "plane_fit_features", "route": "cuda",
         "source": "gem_tpu_torch/csrc/features.cu",
         "replaces": "gem_tpu/kernels/features_pallas.py:42",
         "launches": launches["plane_fit_features"],
         "launches_per_frame": launches["plane_fit_features"] / n_frames,
         "fleet_launches": fleet_launches["plane_fit_features"],
         "max_abs_err": 0.0, "ms": k2_main[1], "plain_ms": k2_main[2],
         "bound_ms": k2_main[3], "bound_by": k2_main[4],
         "library_ms": None, "eager_ms": k2_main[5]},
        {"name": "segment_stats_sorted", "route": "cuda",
         "source": "gem_tpu_torch/csrc/segment_stats.cu",
         "replaces": "gem_tpu/kernels/pallas_scatter.py:40",
         "launches": launches_pallas["segment_stats_sorted"],
         "launches_per_frame":
             launches_pallas["segment_stats_sorted"] / n_frames,
         "fleet_launches": fleet_launches["segment_stats_sorted"],
         "max_abs_err": max(max(r[0] for r in k3.values()), k3_adv_err),
         "ms": k3_main["kernel"], "plain_ms": k3_main["plain"],
         "bound_ms": k3_main["bound"], "bound_by": "bytes",
         "library_ms": k3_main["library"],
         "library_eager_ms": k3_main["library_eager"],
         "wrapper_ms": k3_main["wrapper"]},
    ]
    # the robot-axis forms: one launch for the 4-robot fleet frame
    # (phases 3-5), launches counted on the device in phase 11's fleets
    for k in list(kernels):
        err, ms_, plain, (b_ms, b_by), lib, singles = robots[k["name"]]
        n = fleet_launches[k["name"]]
        kernels.append({
            "name": f"{k['name']} (robot axis, R=4)", "route": "cuda",
            "source": k["source"], "replaces": k["replaces"],
            "launches": n, "launches_per_fleet_frame": n / 10,
            "max_abs_err": err, "ms": ms_, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "four_single_launches_ms": singles})
    k5.update(launches=launches["compact_append"],
              launches_per_frame=launches["compact_append"] / n_frames,
              fleet_launches=fleet_launches["compact_append"])
    kernels += [k4, k5]
    print(f"flagship step_ms_median graph stream={graph_ms['stream'][0]:.3f} "
          f"pallas={graph_ms['pallas'][0]:.3f}, eager stream="
          f"{graph_ms['stream'][1]:.3f} pallas={graph_ms['pallas'][1]:.3f} "
          f"(phase 13); profiled graph stream={step_stream:.3f} pallas="
          f"{step_pallas:.3f} (phase 8); fleet_frame_ms_median(R=4) graph "
          f"stream={fleet_ms['stream']:.3f} pallas="
          f"{fleet_ms['pallas']:.3f} (phase 11), stream graph="
          f"{fleet_graph[0]:.3f} eager={fleet_graph[1]:.3f} (phase 13); "
          f"device events / ms per frame, graph: single step stream="
          f"{graph_ms['stream'][2][1]:.1f} / {graph_ms['stream'][2][2]:.3f}"
          f" fleet frame (R=4)={fleet_graph[2][1]:.1f} / "
          f"{fleet_graph[2][2]:.3f} (phase 13); single step by frame, "
          f"no branch / branch: " + "; ".join(
              f"{k} " + " / ".join(
                  f"{v[c]['device_events']:.1f} ev {v[c]['device_ms']:.3f} ms"
                  if c in v else "none" for c in ("no_branch", "branch"))
              for k, v in branches.items()) + " (phase 13)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
