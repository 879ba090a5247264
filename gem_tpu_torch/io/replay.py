"""Dataset replay: frames in, no ROS.

Counterpart of gem_tpu/io/replay.py, with two sources:

  * `SyntheticWorld` / `synthetic_frames`: procedural terrain, simulated
    LiDAR and a drive.  The generator is the same NumPy code drawing the
    same RNG sequence, so for one seed both packages replay identical
    frames.
  * npz sequences (`load_npz_frame`), one file per frame, padded to
    cfg.max_points by `pad_frame`.

Each frame's arrays become tensors on the requested device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np
import torch

from gem_tpu_torch import native
from gem_tpu_torch.mapping.pipeline import Frame, frame_from_numpy
from gem_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SyntheticWorld:
    """Smooth procedural terrain with optional box obstacles."""

    seed: int = 0
    amplitude: float = 0.6
    wavelength: float = 18.0
    n_obstacles: int = 12
    obstacle_height: float = 1.5
    world_extent: float = 200.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._phases = rng.uniform(0, 2 * math.pi, size=(6,))
        self._freqs = rng.uniform(0.5, 2.0, size=(6, 2)) / self.wavelength
        self._amps = rng.uniform(0.2, 1.0, size=(6,))
        self._amps *= self.amplitude / self._amps.sum()
        self._obs = rng.uniform(-self.world_extent / 2, self.world_extent / 2,
                                size=(self.n_obstacles, 2))
        self._obs_size = rng.uniform(0.5, 2.5, size=(self.n_obstacles,))
        self._obs_h = rng.uniform(0.5, self.obstacle_height,
                                  size=(self.n_obstacles,))

    def height(self, x, y):
        """Vectorised ground truth terrain height."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        z = np.zeros(np.broadcast(x, y).shape)
        for a, (fx, fy), p in zip(self._amps, self._freqs, self._phases):
            z = z + a * np.sin(2 * math.pi * (fx * x + fy * y) + p)
        for (ox, oy), s, h in zip(self._obs, self._obs_size, self._obs_h):
            inside = (np.abs(x - ox) < s) & (np.abs(y - oy) < s)
            z = np.where(inside, z + h, z)
        return z.astype(np.float32)


def _scan_pattern(rng, n_points, max_range, min_range=2.0):
    """Ring-style LiDAR footprint: ranges biased to near field, full
    azimuth."""
    az = rng.uniform(0, 2 * math.pi, n_points)
    r = min_range + (max_range - min_range) * rng.random(n_points) ** 1.5
    return r * np.cos(az), r * np.sin(az)


def synthetic_frames(cfg, n_frames: int, n_points: Optional[int] = None,
                     speed: float = 1.0, noise: float = 0.01, seed: int = 0,
                     max_range: Optional[float] = None,
                     heading: float = 0.35, sensor_height: float = 1.8,
                     device="cuda") -> Iterator[tuple]:
    """Yield (Frame, robot_xy, world) replaying a drive across the world:
    a gentle arc at `speed` m/frame, one simulated scan per frame, points
    in the sensor frame (identity rotation, `sensor_height` above ground).
    The device is checked at the call, before the first frame."""
    return _drive(cfg, n_frames, n_points, speed, noise, seed, max_range,
                  heading, sensor_height, resolve_device(device))


def _drive(cfg, n_frames, n_points, speed, noise, seed, max_range, heading,
           sensor_height, dev):
    world = SyntheticWorld(seed=seed)
    rng = np.random.default_rng(seed + 1)
    P = cfg.max_points
    n_points = min(n_points or min(P, 8192), P)
    if max_range is None:
        max_range = cfg.map.length * cfg.map.resolution * 0.45
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)

    x, y, th = 0.0, 0.0, heading
    for _ in range(n_frames):
        gz = world.height(x, y)
        sensor_z = float(gz + sensor_height)

        ox, oy = _scan_pattern(rng, n_points, max_range)
        wx = x + ox
        wy = y + oy
        wz = world.height(wx, wy) + rng.normal(0, noise, n_points)

        px = (wx - x).astype(np.float32)
        py = (wy - y).astype(np.float32)
        pz = (wz - sensor_z).astype(np.float32)

        pts = np.zeros((P, 3), np.float32)
        pts[:n_points] = np.stack([px, py, pz], -1)
        valid = np.zeros((P,), bool)
        valid[:n_points] = True
        inten = np.zeros((P,), np.float32)
        inten[:n_points] = rng.uniform(1.0, 100.0, n_points)

        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [x, y, sensor_z]

        frame = Frame(
            points=t(pts), intensity=t(inten), valid=t(valid),
            transform=t(T),
            r_base_sensor=t(np.eye(3, dtype=np.float32)),
            t_base_sensor=t(np.zeros(3, np.float32)),
            r_map_base=t(np.eye(3, dtype=np.float32)),
            t_map_base=t(np.asarray([x, y, gz], np.float32)),
            track_position=t(np.asarray([x, y, gz], np.float32)),
            pose_quat=t(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)),
            pose_cov=t(np.zeros((6, 6), np.float32)),
            colors=t(np.zeros((P,), np.int32)),
            image=None,
            loop_closure=t(np.zeros((), bool)),
        )
        yield frame, (x, y), world
        x += speed * math.cos(th)
        y += speed * math.sin(th)
        th += 0.002


# ---------------------------------------------------------------------------
# npz sequences


def pad_frame(cfg, points, intensity=None, colors=None, transform=None,
              track_position=None, device="cuda", **kw) -> Frame:
    """Build a Frame from ragged NumPy inputs, padding to cfg.max_points.

    When cfg.prefilter.leaf > 0 the native voxel-grid pre-filter runs first
    (skipped when per-point colors are already attached, as in
    gem_tpu)."""
    device = resolve_device(device)
    pf = cfg.prefilter
    if pf.leaf > 0 and colors is None:
        points, intensity = native.voxel_filter(
            points, intensity, leaf=pf.leaf,
            crop=(pf.crop_x, pf.crop_y, pf.crop_z))
    P = cfg.max_points
    n = min(len(points), P)
    pts = np.zeros((P, 3), np.float32)
    pts[:n] = np.asarray(points, np.float32)[:n]
    valid = np.zeros((P,), bool)
    valid[:n] = True
    inten = np.zeros((P,), np.float32)
    if intensity is not None:
        inten[:n] = np.asarray(intensity, np.float32)[:n]
    col = np.zeros((P,), np.int32)
    if colors is not None:
        col[:n] = np.asarray(colors, np.int32)[:n]
    T = np.eye(4, dtype=np.float32) if transform is None else \
        np.asarray(transform, np.float32)
    track = np.zeros(3, np.float32) if track_position is None else \
        np.asarray(track_position, np.float32)
    fields = dict(
        r_base_sensor=np.eye(3, dtype=np.float32),
        t_base_sensor=np.zeros(3, np.float32),
        r_map_base=np.eye(3, dtype=np.float32),
        t_map_base=np.asarray(track, np.float32),
        pose_quat=np.asarray([1.0, 0.0, 0.0, 0.0], np.float32),
        pose_cov=np.zeros((6, 6), np.float32), image=None,
        loop_closure=np.zeros((), bool))
    fields.update(kw)
    return frame_from_numpy(Frame(points=pts, intensity=inten, valid=valid,
                                  transform=T, track_position=track,
                                  colors=col, **fields), device)


def load_npz_frame(cfg, path, device="cuda") -> Frame:
    """Frame from one npz record (a path, or raw bytes from a prefetcher).

    Schema (KITTI/YQ converter output): points (N,3) f32 sensor frame,
    intensity (N,), optional colors (N,) packed rgb, transform (4,4)
    sensor->map, track_position (3,), optional pose_quat (4,),
    pose_cov (6,6), image (H,W,3) u8."""
    import io

    d = np.load(io.BytesIO(path) if isinstance(path, bytes) else path)
    kw = {}
    if "pose_quat" in d:
        kw["pose_quat"] = np.asarray(d["pose_quat"], np.float32)
    if "pose_cov" in d:
        kw["pose_cov"] = np.asarray(d["pose_cov"], np.float32)
    if "image" in d:
        kw["image"] = np.asarray(d["image"])
    get = lambda k: d[k] if k in d.files else None
    return pad_frame(cfg, d["points"], get("intensity"), get("colors"),
                     get("transform"), get("track_position"), device=device,
                     **kw)
