"""A fleet in a closed loop, one fleet frame in flight: the online loop
(online.py) over `FleetPipeline`, every robot's frame in one batched step.
Each fleet frame is timed from the moment the harness hands over every
robot's scan, still in host memory, until all the robots' outputs are
complete on the device (synchronised).  Reports `frame_ms_p95`, the 95th
percentile over every fleet frame of the window.

The configuration's `robots` robots each drive a world of their own, drawn
from the seed and the robot's index, on a lapped circuit of their own:
robot r's scans hold `points` x `robot_points[r]` valid points and it
moves `speed_m_per_frame` x `robot_speeds[r]` a frame.  Shed staging is
off for the program and the reference alike, as in every fleet.  The check
holds robot r's slice of each snapshotted state and output against robot r
stepped alone (benchmark/reference/fleet.py); each number is the largest
over the robots."""

import importlib.util
import os

import numpy as np

from benchmark import check, frames, loopkit
from benchmark.reference import fleet as r_fleet

_spec = importlib.util.spec_from_file_location(
    "benchmark_loops_online_fleet",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "online.py"))
_online = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_online)


class Loop(_online.Loop):
    def __init__(self, bench, cell, cfg, rcfg, seed, device, recorder):
        super().__init__(bench, cell, r_fleet.fleet_config(cfg),
                         r_fleet.fleet_config(rcfg), seed, device, recorder)
        self.n_robots = int(cell.config["robots"])
        t = self.traffic
        if not len(t["robot_points"]) == len(t["robot_speeds"]) \
                == self.n_robots:
            raise ValueError(f"{cell.name}: robot_points and robot_speeds "
                             f"must give each of {self.n_robots} robots")

    # -- set-up -------------------------------------------------------------
    def _robot_traffic(self, r: int) -> dict:
        """Robot r's share of the traffic: its points and its speed."""
        t = dict(self.traffic)
        t["points"] = int(round(int(t["points"]) * t["robot_points"][r]))
        t["speed_m_per_frame"] = float(t["speed_m_per_frame"]) \
            * t["robot_speeds"][r]
        return t

    def _robot_seed(self, r: int) -> int:
        return int(np.random.SeedSequence([int(self.seed), r])
                   .generate_state(1)[0])

    def make_feed(self):
        pattern = self.bench.plugin("scans", self.traffic["scan"]).pattern
        scans = [frames.make_scans(self._robot_traffic(r),
                                   self._robot_seed(r), self.device, pattern)
                 for r in range(self.n_robots)]
        self.phases("scans")
        feed = self.bench.plugin("feeds", self.traffic["feed"]).Feed(
            self.cfg, self.rcfg, self.traffic, scans, self.device)
        self.phases("feed")
        return feed

    def make_pipeline(self):
        """The fleet, warmed up on the circuits' first frames."""
        from gem_tpu_torch.multirobot.fleet import FleetPipeline

        self.pipe = FleetPipeline(
            self.cfg, self.n_robots, device=self.device,
            fuse_backend=self.cell.config.get("fuse_backend", "stream"))
        self.warmup = int(self.traffic["warmup_frames"])
        for g in range(self.warmup):
            out = self.pipe.process(self.feed.device_frame(g))
        self.phases("warmup")
        self.start = loopkit.Snapshot(self.pipe.state, self.pin)
        self.start.take(self.pipe.state)
        self.out_like = out
        self.frame_like = self.feed.device_frame(0)

    def _plan(self, lo: int, hi: int, count: int):
        """Checked fleet frames, half of them where some robot's keyframe
        is due."""
        kf = set()
        for r in range(self.n_robots):
            kf |= loopkit.predicted_keyframes(
                self.cfg, self.feed.n_frames,
                self._robot_traffic(r)["speed_m_per_frame"], hi)
        for g in loopkit.sample_units(self.rng, count, lo, hi, kf):
            self.samples[g] = self._buffers()

    # -- after the window ---------------------------------------------------
    def _fleet_step(self, states: list, g: int, control: bool):
        with loopkit.precision(control):
            return r_fleet.step(
                states, self.feed.reference_frame(g % self.feed.n_frames),
                self.rcfg)

    def _robots(self, tree) -> list:
        """Each robot's slice of a snapshotted tree, on the device."""
        return [check.to_reference(r_fleet.robot(tree, r), self.device)
                for r in range(self.n_robots)]

    def check(self, control: bool = False) -> dict:
        """The numbers: the start, then each checked fleet frame that the
        window reached, robot by robot.  `control` puts the reference in
        TF32 in the program's place."""
        n, dev = self.n_robots, self.device
        numbers = {}
        ref = r_fleet.init_fleet(self.rcfg, n, dev)
        cand = r_fleet.init_fleet(self.rcfg, n, dev) if control else None
        for g in range(self.warmup):
            ref, _ = self._fleet_step(ref, g, False)
            if control:
                cand, _ = self._fleet_step(cand, g, True)
        for r in range(n):
            got = cand[r] if control else r_fleet.robot(self.start.tree, r)
            check.merge(numbers, check.frame_numbers(ref[r], None, got, None,
                                                     self.cfg))
        del ref, cand
        checked = 0
        for g, s in sorted(self.samples.items()):
            if not s["done"]:
                continue
            checked += 1
            r_states, r_outs = self._fleet_step(self._robots(s["pre"].tree),
                                                g, False)
            if control:
                got = zip(*self._fleet_step(self._robots(s["pre"].tree), g,
                                            True))
            else:
                got = ((r_fleet.robot(s["post"].tree, r),
                        r_fleet.robot(s["out"].tree, r)) for r in range(n))
            for r, (state, out) in enumerate(got):
                check.merge(numbers, check.frame_numbers(
                    r_states[r], r_outs[r], state, out, self.cfg))
            del r_states, r_outs
        if not checked:
            raise RuntimeError("the window reached no checked frame")
        self.checked = checked
        return numbers

    def kernel_work(self) -> list:
        """Per fleet frame of the profiled slice, each work count summed
        over the robots, element by element: the robot-axis launch does
        the four robots' work at once."""
        lo, hi = self.slice
        per_robot = []
        for r, start in enumerate(self._robots(self.preslice.tree)):
            frames_ = [self.feed.robot_frame(g % self.feed.n_frames, r)
                       for g in range(lo, hi)]
            per_robot.append(check.kernel_work(start, frames_, self.rcfg,
                                               self.work))
        return [{k: tuple(map(sum, zip(*(w[k] for w in ws))))
                 for k in ws[0]} for ws in zip(*per_robot)]
