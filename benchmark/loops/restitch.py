"""Loop-closure re-stitches of a full submap ring.  Set-up drives the
circuit through the step until every slot holds a submap; then events run
back to back, each from the same filled store (restored outside the timed
span), its corrected poses the `--loop-demo` drift ramp over the keyframe
ids with its end (`ramp_end`) scaled per event by a factor drawn from the
seed in `ramp_scale`.  Each event is timed from the hand-over of the
corrected poses to `apply_loop_closure` until the re-stitched store is back
in the pipeline's state and the device has finished.  Reports
`restitch_ms_p95` over every event of the window."""

import time

import numpy as np
import torch

from benchmark import check, loopkit
from benchmark.reference import loop_closure as r_loop


class Loop(loopkit.FrameLoop):
    def setup(self):
        from gem_tpu_torch.utils.tree import tree_map

        t = self.traffic
        self.phases = ph = loopkit.Phases(self.device)
        self.feed = self.make_feed()
        self.make_pipeline()
        self.slice = None
        K = self.cfg.submap.max_submaps
        fill_max = int(t["fill_frames_max"])
        self._plan(self.warmup, self.warmup + int(t["check_within"]),
                   int(t["check_frames"]))
        # the fill: through the step until every slot holds a submap
        self.k = self.warmup
        while self.k < fill_max:
            g = self.k
            self._before(g)
            f, out = self.frame()
            self._after(g, f, out)
            self.k += 1
            if g % 8 == 7 and int(self.pipe.state.submaps.num_submaps) >= K:
                break
        n_sub = int(self.pipe.state.submaps.num_submaps)
        if n_sub < K:
            raise RuntimeError(f"the fill made {n_sub} submaps of {K} in "
                               f"{fill_max} frames")
        self.fill_frames = self.k
        ph("fill")
        store = self.pipe.state.submaps
        self.filled = loopkit.Snapshot(store, self.pin)
        self.filled.take(store)
        self.filled_dev = tree_map(torch.clone, store)
        # the corrected poses: the --loop-demo drift ramp over the keyframe
        # ids, its end drawn per event from the seed
        ids = store.kf_ids.cpu().numpy()
        poses = store.poses.cpu().numpy()
        base = np.zeros((n_sub, 7), np.float32)
        base[ids[ids >= 0]] = poses[ids >= 0]
        self.base_poses = base
        end = np.asarray(t["ramp_end"], np.float64)
        lo, hi = t["ramp_scale"]
        n_events = int(t["events_max"])
        self.ramp_scales = self.rng.uniform(lo, hi, size=n_events)
        self.ramp = np.linspace(0, 1, n_sub)[:, None] * end[None, :]
        self.e = 0
        self.event_samples = {}
        ph("store")
        for _ in range(int(t["warmup_events"])):
            self.event()
        ph("warmup_events")
        self.preroll()
        w = self.e
        within = w + int(t["check_events_within"])
        if self.rec.enabled:
            lo_e = within + int(t["trace_from"])
            self.slice = (lo_e, lo_e + int(t["trace_frames"]))
        for e in loopkit.sample_units(self.rng, int(t["check_events"]), w,
                                      within):
            self.event_samples[e] = {"post": loopkit.Snapshot(store, self.pin),
                                     "done": False}
        ph("snapshots")

    def _checked(self) -> dict:
        return self.event_samples

    def poses(self, e: int) -> np.ndarray:
        return (self.base_poses + self.ramp_scales[e] * self.ramp
                ).astype(np.float32)

    def event(self):
        """One re-stitch event from the filled store; returns its time."""
        from gem_tpu_torch.global_map.loop_closure import apply_loop_closure

        e = self.e
        if self.slice and e == self.slice[0]:
            self._slice_cm = self.rec.slice()
            self._slice_cm.__enter__()
        with self.rec.span("restore"):
            self.pipe.state = self.pipe.state.replace(
                submaps=self.filled_dev)
            loopkit.sync(self.device)
        opt = self.poses(e)
        with self.rec.span("event"):
            t0 = time.perf_counter()
            with self.rec.span("restitch"):
                store, stats = apply_loop_closure(self.pipe.state.submaps,
                                                  self.cfg, opt)
                self.pipe.state = self.pipe.state.replace(submaps=store)
            with self.rec.span("sync"):
                loopkit.sync(self.device)
            t1 = time.perf_counter()
        s = self.event_samples.get(e)
        if s is not None:
            s["post"].take(self.pipe.state.submaps)
            s["stats"] = dict(stats)
            s["done"] = True
        if self.slice and e == self.slice[1] - 1:
            self._slice_cm.__exit__(None, None, None)
            self.trace_units = self.slice[1] - self.slice[0]
        self.e += 1
        return t1 - t0

    def window(self, seconds: float) -> dict:
        times = []
        t_start = time.perf_counter()
        while True:
            times.append(self.event())
            if time.perf_counter() - t_start >= seconds \
                    and not self._pending():
                break
            if self.e >= len(self.ramp_scales):
                raise RuntimeError("events_max reached inside the window")
        self.attempted = len(times)
        return {"restitch_ms_p95": float(np.percentile(times, 95)) * 1e3}

    def release(self):
        self.filled_dev = None
        super().release()

    def check(self, control: bool = False) -> dict:
        numbers = super().check(control)
        dev = self.device
        checked = 0
        for e, s in sorted(self.event_samples.items()):
            if not s["done"]:
                continue
            checked += 1
            opt = self.poses(e)
            with loopkit.precision(False):
                r_store, r_stats = r_loop.apply_loop_closure(
                    check.to_reference(self.filled.tree, dev), self.rcfg,
                    opt)
            if control:
                with loopkit.precision(True):
                    got = r_loop.apply_loop_closure(
                        check.to_reference(self.filled.tree, dev),
                        self.rcfg, opt)
            else:
                got = (s["post"].tree, s["stats"])
            check.merge(numbers, check.restitch_numbers(
                r_store, r_stats, *got, self.cfg))
        if not checked:
            raise RuntimeError("the window reached no checked event")
        self.checked_events = checked
        return numbers

