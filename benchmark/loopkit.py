"""What the driver loops (benchmark/loops/<loop>.py) and the feeds
(benchmark/feeds/<feed>.py) are built from.

A loop file defines `Loop`, made as `Loop(bench, cell, cfg, rcfg, seed,
device, recorder)`; the harness sets `loop.work` (the work plug-ins that
the traced run's readers need, by name), then calls `setup()`, `window(
seconds)` (the end-to-end metrics by name), and after the window
`release()`, `check(control)` (the numbers compared) and, traced,
`kernel_work()`; it reads `phases`, `attempted` and `trace_units`.
`FrameLoop` is such a loop over the frames of a circuit: it makes the scans
(frames.py, with the traffic file's `scan` pattern), hands them over
through the traffic file's `feed`, and checks the frames it snapshotted in
the window against the reference; a loop file gives it a `window`.

A feed file defines `Feed(cfg, rcfg, traffic, scans, device)`, a
`FeedBase`: how the program receives frame i (`device_frame`) and how the
reference makes it from the same scan (`reference_frame`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import check, frames
from benchmark.reference import pipeline as r_pipeline
from benchmark.reference import precision as r_precision


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Phases:
    """Set-up phases on the host clock (synchronised), for standard
    error."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()
        self.done = []

    def __call__(self, name: str):
        sync(self.device)
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return " ".join(f"{n}={s:.3f}s" for n, s in self.done)


class Snapshot:
    """Host buffers shaped as a tree of device tensors, filled by copies
    queued on the stream (no synchronise)."""

    def __init__(self, like, pin: bool):
        from gem_tpu_torch.utils.tree import tree_map

        self.tree = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=pin), like)

    def take(self, tree):
        from gem_tpu_torch.utils.tree import tree_map

        tree_map(lambda d, s: d.copy_(s, non_blocking=True), self.tree, tree)


class FeedBase:
    """The circuit's frames as the program and the reference receive them:
    each frame's sensor pose `T` (4 x 4) and track position, and the
    scans' sizes.  A feed whose `keeps_frame` is set has the frame it
    handed over snapshotted at each checked frame, and `check_frame` holds
    it against the reference's; `pool` gives, for a keyframe that the
    frame wrote, the points its stored scan may be drawn from (held then
    by membership, not row by row), or None."""

    keeps_frame = False

    def __init__(self, cfg, rcfg, traffic, scans, device):
        self.cfg, self.rcfg, self.device = cfg, rcfg, torch.device(device)
        self.pin = self.device.type == "cuda"
        N, n = scans.points.shape[:2]
        P = cfg.max_points
        if n > P:
            # a raw scan of n points can never filter to more than n
            raise ValueError(f"scans of {n} points exceed max_points {P}")
        self.n_frames, self.n_valid = N, n
        pose = scans.pose.numpy()
        T = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
        T[:, 0, 3], T[:, 1, 3], T[:, 2, 3] = pose[:, 0], pose[:, 1], pose[:, 3]
        track = np.ascontiguousarray(pose[:, :3])
        self.T, self.track = T, track

    def device_frame(self, i: int):
        raise NotImplementedError

    def reference_frame(self, i: int):
        raise NotImplementedError

    def check_frame(self, ref_frame, frame) -> dict:
        return {}

    def pool(self, ref_frame):
        return None


def predicted_keyframes(cfg, n_frames: int, speed: float, upto: int) -> set:
    """The frames (global index) whose finalize is due, replaying the
    step's rule (distance from the last keyframe >= keyframe_distance) on
    the circuit's positions in float32."""
    xs, ys, _ = frames.circuit(n_frames, speed)
    last = np.zeros(2, np.float32)
    out = set()
    for g in range(upto):
        p = np.asarray([xs[g % n_frames], ys[g % n_frames]], np.float32)
        if np.linalg.norm(p - last) >= np.float32(
                cfg.submap.keyframe_distance):
            out.add(g)
            last = p
    return out


def sample_units(rng, count: int, lo: int, hi: int, prefer=()) -> list:
    """`count` distinct units in [lo, hi), half of them (rounded up) from
    `prefer` where it has enough there."""
    prefer = sorted(u for u in prefer if lo <= u < hi)
    want = min(len(prefer), (count + 1) // 2)
    picked = set(rng.choice(prefer, size=want, replace=False).tolist()) \
        if want else set()
    rest = [u for u in range(lo, hi) if u not in picked]
    picked |= set(rng.choice(rest, size=count - len(picked),
                             replace=False).tolist())
    return sorted(int(u) for u in picked)


class FrameLoop:
    """A loop over the frames of a circuit, through `ElevationPipeline`;
    a loop file subclasses it with its `window`, which calls `_before(g)`,
    `frame()` and `_after(g, frame, out)` for each frame g, keeps
    `_pending()` in view and sets `attempted`."""

    def __init__(self, bench, cell, cfg, rcfg, seed: int, device, recorder):
        self.bench, self.cell, self.cfg, self.rcfg = bench, cell, cfg, rcfg
        self.traffic = cell.traffic
        self.seed, self.device, self.rec = seed, torch.device(device), recorder
        self.pin = self.device.type == "cuda"
        self.rng = np.random.default_rng([int(seed), 1])
        self.samples = {}          # global frame -> snapshots
        self.preslice = None
        self.trace_units = 0
        self.attempted = 0
        self.work = {}             # the work plug-ins the readers need

    # -- set-up -------------------------------------------------------------
    def make_feed(self):
        """The traffic's scans, made from the seed with its `scan`
        pattern, as its `feed` hands them over."""
        t = self.traffic
        scans = frames.make_scans(t, self.seed, self.device,
                                  self.bench.plugin("scans", t["scan"])
                                  .pattern)
        self.phases("scans")
        feed = self.bench.plugin("feeds", t["feed"]).Feed(
            self.cfg, self.rcfg, t, scans, self.device)
        self.phases("feed")
        return feed

    def make_pipeline(self):
        """The program, warmed up on the circuit's first frames."""
        from gem_tpu_torch.mapping.pipeline import ElevationPipeline

        self.pipe = ElevationPipeline(
            self.cfg, device=self.device,
            fuse_backend=self.cell.config.get("fuse_backend", "stream"))
        self.warmup = int(self.traffic["warmup_frames"])
        for g in range(self.warmup):
            out = self.pipe.process(self.feed.device_frame(g))
        self.phases("warmup")
        self.start = Snapshot(self.pipe.state, self.pin)
        self.start.take(self.pipe.state)
        self.out_like = out
        self.frame_like = self.feed.device_frame(0)

    def setup(self):
        self.phases = Phases(self.device)
        self.feed = self.make_feed()
        self.make_pipeline()
        self.k = self.warmup
        self.slice = None
        self.preroll()
        t = self.traffic
        base = self.k
        if self.rec.enabled:
            lo = base + int(t["trace_from"])
            self.slice = (lo, lo + int(t["trace_frames"]))
        self._plan(base + int(t["trace_from"]) + int(t["trace_frames"]),
                   base + int(t["check_within"]), int(t["check_frames"]))
        self.phases("snapshots")

    def preroll(self):
        """The cell's own traffic for `preroll_s` seconds, in set-up and
        before anything is planned in the window: on the card's machine the
        host's work runs up to a sixth slower until 25-40 s after the
        process starts (replay: 470-480 against 545-558 frames/s, the GPU
        at 1980 MHz in both), which spread the windows of runs that
        started the same."""
        seconds = float(self.traffic.get("preroll_s", 0))
        if seconds > 0:
            self.window(seconds)
            self.phases("preroll")

    def _plan(self, lo: int, hi: int, count: int):
        kf = predicted_keyframes(self.cfg, self.feed.n_frames,
                                 float(self.traffic["speed_m_per_frame"]),
                                 hi)
        for g in sample_units(self.rng, count, lo, hi, kf):
            self.samples[g] = self._buffers()

    def _buffers(self) -> dict:
        b = {"pre": Snapshot(self.pipe.state, self.pin),
             "post": Snapshot(self.pipe.state, self.pin),
             "out": Snapshot(self.out_like, self.pin), "done": False}
        if self.feed.keeps_frame:
            b["frame"] = Snapshot(self.frame_like, self.pin)
        return b

    # -- one frame ----------------------------------------------------------
    def _before(self, g: int):
        if self.slice and g == self.slice[0]:
            if self.work:
                self.preslice = Snapshot(self.pipe.state, self.pin)
                self.preslice.take(self.pipe.state)
            self._slice_cm = self.rec.slice()
            self._slice_cm.__enter__()
        if g in self.samples:
            self.samples[g]["pre"].take(self.pipe.state)

    def _after(self, g: int, frame, out):
        s = self.samples.get(g)
        if s is not None:
            s["post"].take(self.pipe.state)
            s["out"].take(out)
            if "frame" in s:
                s["frame"].take(frame)
            s["done"] = True
        if self.slice and g == self.slice[1] - 1:
            self._slice_cm.__exit__(None, None, None)
            self.trace_units = self.slice[1] - self.slice[0]

    def _pending(self) -> bool:
        """The window lasts `seconds`, and until its checked units and a
        traced run's profiled slice are done: an answer that comes late is
        late, not wrong."""
        return (bool(self.slice) and not self.trace_units) or any(
            not s["done"] for s in self._checked().values())

    def _checked(self) -> dict:
        return self.samples

    def frame(self):
        """Hand over frame k, enqueue it; returns (frame, outputs)."""
        g = self.k
        with self.rec.span("intake"):
            f = self.feed.device_frame(g % self.feed.n_frames)
        with self.rec.span("enqueue"):
            out = self.pipe.process(f)
        return f, out

    # -- after the window ---------------------------------------------------
    def release(self):
        """Drop the program's state and graphs before the reference runs."""
        sync(self.device)
        self.pipe = self.out_like = self.frame_like = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_frame(self, g: int, control: bool):
        with precision(control):
            return self.feed.reference_frame(g % self.feed.n_frames)

    def _ref_step(self, state, g: int, control: bool):
        f = self._ref_frame(g, control)
        with precision(control):
            new, out = r_pipeline.step(state, f, self.rcfg)
        return new, out, f

    def check(self, control: bool = False) -> dict:
        """The numbers: the start, then each checked frame that the window
        reached.  `control` puts the reference in TF32 in the program's
        place."""
        dev = self.device
        numbers = {}
        ref = r_pipeline.init_pipeline_state(self.rcfg, dev)
        cand = r_pipeline.init_pipeline_state(self.rcfg, dev) if control \
            else None
        pools = {}
        for g in range(self.warmup):
            before = ref.submaps.kf_points.clone()
            ref, _, r_frame = self._ref_step(ref, g, False)
            pools.update(self._pools(before, ref, r_frame))
            if control:
                cand, _, _ = self._ref_step(cand, g, True)
        check.merge(numbers, check.frame_numbers(
            ref, None, cand if control else self.start.tree, None,
            self.cfg, pools or None))
        checked = 0
        for g, s in sorted(self.samples.items()):
            if not s["done"]:
                continue
            checked += 1
            pre = s["pre"].tree
            r_state, r_out, r_frame = self._ref_step(
                check.to_reference(pre, dev), g, False)
            if control:
                c_state, c_out, c_frame = self._ref_step(
                    check.to_reference(pre, dev), g, True)
                got = (c_state, c_out)
            else:
                got = (s["post"].tree, s["out"].tree)
                c_frame = s.get("frame") and s["frame"].tree
            if self.feed.keeps_frame:
                check.merge(numbers, self.feed.check_frame(r_frame, c_frame))
            pools = self._pools(pre.submaps.kf_points, r_state, r_frame)
            check.merge(numbers, check.frame_numbers(r_state, r_out, *got,
                                                     self.cfg, pools or None))
            del r_state, r_out
        if not checked:
            raise RuntimeError("the window reached no checked frame")
        self.checked = checked
        return numbers

    def _pools(self, kf_before, ref_after, ref_frame) -> dict:
        """{slot: the feed's pool} for each keyframe slot the frame wrote,
        where the feed holds stored scans by membership."""
        pool = self.feed.pool(ref_frame)
        if pool is None:
            return {}
        return {slot: pool for slot in check.written_slots(
            kf_before, ref_after.submaps.kf_points)}

    def kernel_work(self) -> list:
        lo, hi = self.slice
        frames_ = [self.feed.reference_frame(g % self.feed.n_frames)
                   for g in range(lo, hi)]
        return check.kernel_work(
            check.to_reference(self.preslice.tree, self.device), frames_,
            self.rcfg, self.work)


@contextlib.contextmanager
def precision(control: bool):
    """The reference in TF32 (the control) inside the block."""
    old = r_precision.TF32
    r_precision.TF32 = control
    try:
        yield
    finally:
        r_precision.TF32 = old
