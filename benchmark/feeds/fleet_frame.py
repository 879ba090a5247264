"""A fleet frame: every robot's padded Frame in host memory (pinned on a
card), as `frame.py` holds one robot's, handed over at once as one Frame
with a leading robot axis.  Each robot's points and intensities are its own
host buffers, uploaded into its row of the batch; the small per-frame
leaves (poses, tracks) and the constant ones (valid masks, colors) are held
stacked over the robots, one upload each.  The reference receives each
robot's host frame alone (`robot_frame`)."""

import importlib.util
import os

import torch

from benchmark import check, loopkit

_spec = importlib.util.spec_from_file_location(
    "benchmark_feeds_frame_robot",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "frame.py"))
_frame = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_frame)


class Feed(loopkit.FeedBase):
    """`scans` is a list with one `frames.Scans` per robot, all of one
    circuit length; `n_valid` is the fleet frame's valid points."""

    def __init__(self, cfg, rcfg, traffic, scans, device):
        self.robots = [_frame.Feed(cfg, rcfg, traffic, s, device)
                       for s in scans]
        first = self.robots[0]
        self.cfg, self.rcfg, self.device = cfg, rcfg, first.device
        self.pin = first.pin
        self.n_frames = first.n_frames
        if any(f.n_frames != self.n_frames for f in self.robots):
            raise ValueError("the robots' circuits differ in length")
        self.n_valid = sum(f.n_valid for f in self.robots)
        hold = (lambda t: t.pin_memory()) if self.pin else (lambda t: t)
        stack = lambda ts, dim: hold(torch.stack(ts, dim).contiguous())
        self.transforms = stack([f.transforms for f in self.robots], 1)
        self.tracks = stack([f.tracks for f in self.robots], 1)
        self.shared = {k: stack([f.shared[k] for f in self.robots], 0)
                       for k in first.shared}

    def device_frame(self, i: int):
        from gem_tpu_torch.mapping.pipeline import Frame

        up = lambda t: t.to(self.device, non_blocking=True)
        P = self.cfg.max_points
        R = len(self.robots)
        points = torch.empty((R, P, 3), dtype=torch.float32,
                             device=self.device)
        intensity = torch.empty((R, P), dtype=torch.float32,
                                device=self.device)
        for r, f in enumerate(self.robots):
            points[r].copy_(f.points[i], non_blocking=True)
            intensity[r].copy_(f.intensity[i], non_blocking=True)
        track = up(self.tracks[i])
        return Frame(points=points, intensity=intensity,
                     transform=up(self.transforms[i]), t_map_base=track,
                     track_position=track, image=None,
                     **{k: up(v) for k, v in self.shared.items()})

    def robot_frame(self, i: int, r: int):
        """Robot r's frame i as the reference receives it."""
        return check.to_reference(self.robots[r].host_frame(i), self.device)

    def reference_frame(self, i: int):
        return [self.robot_frame(i, r) for r in range(len(self.robots))]
