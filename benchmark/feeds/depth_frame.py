"""An organized depth cloud per frame, as the camera hands it over: every
pixel a lane, all lanes marked valid, NaN where the pixel has no
depth, the points in the optical frame of the frame's own camera (scan
pattern `d435`: frame g is camera g % C's).  Each frame carries its
camera's extrinsic: `r_base_sensor` (base from optical), `t_base_sensor`
(the camera `sensor_height_m` above the base, which stands on the ground
under the robot) and `transform` (sensor to map), with the base
world-aligned (`r_map_base` the identity).  The clouds and poses are
one pinned host row a frame (points, intensity, `transform`, track),
uploaded in one copy as the program's input, each leaf a view of it.
What no frame changes, each camera's extrinsic and the constant lanes
(`valid`, `colors`, the identities), is put on the device once and handed
over with each frame, as a driver keeps it.  So the host's work before the
program can start is one copy, not one per leaf: in this closed loop that
work lies on every frame's critical path, and a slower host stretches it.
No loop closure: `loop_closure` is None.

The reference receives the cloud as upstream's `cleanPointCloud` leaves
it (reference/organized.py): the non-finite points removed in pixel order,
then zero padding that is not valid."""

import dataclasses
import importlib.util
import os

import numpy as np
import torch

from benchmark import check, loopkit
from benchmark.reference import organized as r_organized

_spec = importlib.util.spec_from_file_location(
    "benchmark_scans_d435_camera",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scans", "d435.py"))
_d435 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_d435)

# frames rotated into their cameras' frames per device call
_CHUNK = 64


def to_optical(points, rots, cam):
    """points (m, n, 3) in world-aligned axes, each frame's rotation
    rots[cam] (base from optical): the points in the optical frames,
    R^T p written out per axis, in float64."""
    r = rots[cam]                                      # (m, 3, 3)
    p = points.to(torch.float64)
    return torch.stack([p[..., 0] * r[:, None, 0, k]
                        + p[..., 1] * r[:, None, 1, k]
                        + p[..., 2] * r[:, None, 2, k] for k in range(3)], -1)


class Feed(loopkit.FeedBase):
    def __init__(self, cfg, rcfg, traffic, scans, device):
        super().__init__(cfg, rcfg, traffic, scans, device)
        N, P = self.n_frames, cfg.max_points
        if self.n_valid != P:
            raise ValueError(f"an organized cloud of {self.n_valid} lanes "
                             f"fills no frame of max_points {P}")
        rots = _d435.rotations(traffic)
        C = rots.shape[0]
        self.cameras = C
        r32 = rots.to(torch.float32).numpy()
        T = self.T.copy()
        T[:, :3, :3] = r32[np.arange(N) % C]
        # each frame's upload in one row: points, intensity, transform,
        # track
        rows = torch.empty((N, 4 * P + 19), dtype=torch.float32,
                           pin_memory=self.pin)
        dev_rots = rots.to(self.device)
        for lo in range(0, N, _CHUNK):
            hi = min(lo + _CHUNK, N)
            cam = torch.arange(lo, hi, device=self.device) % C
            opt = to_optical(scans.points[lo:hi].to(self.device), dev_rots,
                             cam)
            rows[lo:hi, :3 * P].copy_(opt.to(torch.float32).flatten(1))
        rows[:, 3 * P:4 * P] = scans.intensity
        rows[:, 4 * P:] = torch.from_numpy(
            np.concatenate([T.reshape(N, 16), self.track], 1))
        self.rows = rows
        self.points = rows[:, :3 * P].view(N, P, 3)
        self.intensity = rows[:, 3 * P:4 * P]
        self.transforms = rows[:, 4 * P:4 * P + 16].view(N, 4, 4)
        self.tracks = rows[:, 4 * P + 16:]
        hold = lambda a: (torch.from_numpy(np.array(a)).pin_memory()
                          if self.pin else torch.from_numpy(np.array(a)))
        self.r_base_sensor = hold(r32)
        self.t_base_sensor = hold(np.tile(np.asarray(
            [0.0, 0.0, float(traffic["sensor_height_m"])], np.float32),
            (C, 1)))
        self.shared = dict(
            valid=hold(np.ones(P, bool)),
            r_map_base=hold(np.eye(3, dtype=np.float32)),
            pose_quat=hold(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)),
            pose_cov=hold(np.zeros((6, 6), np.float32)),
            colors=hold(np.zeros((P,), np.int32)),
            loop_closure=None)
        # per camera: its extrinsic and the constant lanes, on the device
        up = lambda t: None if t is None else t.to(self.device)
        self.resident = [dict(r_base_sensor=up(self.r_base_sensor[c]),
                              t_base_sensor=up(self.t_base_sensor[c]),
                              **{k: up(v) for k, v in self.shared.items()})
                         for c in range(C)]

    def host_frame(self, i: int):
        """Frame `i` of the circuit in host memory, camera i % C's."""
        from gem_tpu_torch.mapping.pipeline import Frame

        c = i % self.cameras
        return Frame(points=self.points[i], intensity=self.intensity[i],
                     transform=self.transforms[i],
                     r_base_sensor=self.r_base_sensor[c],
                     t_base_sensor=self.t_base_sensor[c],
                     t_map_base=self.tracks[i],
                     track_position=self.tracks[i], image=None,
                     **self.shared)

    def device_frame(self, i: int):
        """Frame `i` on the device: its cloud and pose uploaded, its
        camera's extrinsic and the constant lanes already there."""
        from gem_tpu_torch.mapping.pipeline import Frame

        P = self.cfg.max_points
        row = self.rows[i].to(self.device, non_blocking=True)
        track = row[4 * P + 16:]
        return Frame(points=row[:3 * P].view(P, 3),
                     intensity=row[3 * P:4 * P],
                     transform=row[4 * P:4 * P + 16].view(4, 4),
                     t_map_base=track, track_position=track, image=None,
                     **self.resident[i % self.cameras])

    def reference_frame(self, i: int):
        f = check.to_reference(self.host_frame(i), self.device)
        points, intensity, valid = r_organized.clean(
            f.points, f.intensity, self.rcfg.max_points)
        return dataclasses.replace(f, points=points, intensity=intensity,
                                   valid=valid)
