"""The benchmark's traffic generator: a seeded world, a closed circuit and
the scans along it, made on the device in a few large calls.

A torch rewrite of the port's synthetic replay (`SyntheticWorld` and
`_scan_pattern` of gem_tpu_torch/io/replay.py), frozen here so that the
yardstick does not move with the program:

  * `World`: smooth relief (six sines) plus box obstacles, its parameters
    drawn from the seed as `SyntheticWorld` draws them, over an extent that
    covers the circuit;
  * the circuit: a circle driven at a fixed speed that closes on itself
    after `circuit_frames` frames, so lapped frames see the same terrain;
  * the scan pattern that the traffic file's `scan` names, a file of its
    own (benchmark/scans/<scan>.py) whose `pattern(traffic, gen, m, n,
    device)` draws the horizontal offsets of m scans of n points, and
    optionally the heights of structures above the terrain: "ring" is
    `_scan_pattern`'s footprint, "hdl64" a raw Velodyne HDL-64E sweep.

Points are in the sensor frame (identity rotation, the sensor
`sensor_height` above the ground), as the port's own replay makes them.
Every seed gets the same sizes: only the terrain and the draws differ.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

class World:
    """Seeded terrain, evaluated on the device (float64, then float32, as
    `SyntheticWorld.height`)."""

    def __init__(self, seed: int, extent: float, device,
                 amplitude: float = 0.6, wavelength: float = 18.0,
                 n_obstacles: int = 12, obstacle_height: float = 1.5):
        rng = np.random.default_rng(seed)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      device=device)
        self.phases = t(rng.uniform(0, 2 * math.pi, size=(6,)))
        self.freqs = t(rng.uniform(0.5, 2.0, size=(6, 2)) / wavelength)
        amps = rng.uniform(0.2, 1.0, size=(6,))
        self.amps = t(amps * amplitude / amps.sum())
        self.obs = t(rng.uniform(-extent / 2, extent / 2,
                                 size=(n_obstacles, 2)))
        self.obs_size = t(rng.uniform(0.5, 2.5, size=(n_obstacles,)))
        self.obs_h = t(rng.uniform(0.5, obstacle_height,
                                   size=(n_obstacles,)))

    def height(self, x, y):
        x = x.to(torch.float64)
        y = y.to(torch.float64)
        z = torch.zeros_like(x)
        for k in range(self.amps.shape[0]):
            z = z + self.amps[k] * torch.sin(
                2 * math.pi * (self.freqs[k, 0] * x + self.freqs[k, 1] * y)
                + self.phases[k])
        for k in range(self.obs.shape[0]):
            inside = ((x - self.obs[k, 0]).abs() < self.obs_size[k]) \
                & ((y - self.obs[k, 1]).abs() < self.obs_size[k])
            z = torch.where(inside, z + self.obs_h[k], z)
        return z.to(torch.float32)


@dataclasses.dataclass
class Scans:
    """The circuit's scans on the host.

    points (N, n, 3) and intensity (N, n) float32: n points per scan (the
    first `n` lanes of a padded frame, or a raw scan); pose (N, 4) float32:
    robot x, y, ground z and sensor z per frame."""

    points: torch.Tensor
    intensity: torch.Tensor
    pose: torch.Tensor


def circuit(n_frames: int, speed: float):
    """(x, y, heading) of each frame on a circle of circumference
    n_frames * speed, from the origin heading +x, counter-clockwise."""
    radius = n_frames * speed / (2 * math.pi)
    phi = 2 * math.pi * np.arange(n_frames) / n_frames
    return radius * np.sin(phi), radius * (1 - np.cos(phi)), phi


def make_scans(traffic: dict, seed: int, device, pattern,
               chunk: int = 64) -> Scans:
    """Every frame of the traffic's circuit, generated on `device` from
    `seed` and returned in host memory (pinned when `device` is a card).
    `pattern(traffic, gen, m, n, device) -> (dx, dy, structure_z)`: the
    offsets of each point from the sensor (float64, (m, n)), and the
    height above the sensor of the structure each point hits, NaN (or
    `structure_z` None) where it hits the terrain."""
    n_frames = int(traffic["circuit_frames"])
    speed = float(traffic["speed_m_per_frame"])
    n = int(traffic["points"])
    max_range = float(traffic["max_range_m"])
    sensor_height = float(traffic["sensor_height_m"])
    noise = float(traffic["noise_m"])
    xs, ys, _ = circuit(n_frames, speed)
    radius = n_frames * speed / (2 * math.pi)
    world = World(seed, 2 * (radius + max_range) + 20.0, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    dev = torch.device(device)
    pin = dev.type == "cuda"
    points = torch.empty((n_frames, n, 3), dtype=torch.float32,
                         pin_memory=pin)
    inten = torch.empty((n_frames, n), dtype=torch.float32, pin_memory=pin)
    rx = torch.as_tensor(xs, dtype=torch.float64, device=dev)
    ry = torch.as_tensor(ys, dtype=torch.float64, device=dev)
    gz = world.height(rx, ry)
    sz = gz + sensor_height
    for lo in range(0, n_frames, chunk):
        hi = min(lo + chunk, n_frames)
        m = hi - lo
        cx, cy = rx[lo:hi, None], ry[lo:hi, None]
        ox, oy, structure_z = pattern(traffic, gen, m, n, dev)
        wz = world.height(cx + ox, cy + oy).to(torch.float64) \
            + noise * torch.randn((m, n), generator=gen, device=dev,
                                  dtype=torch.float64)
        if structure_z is not None:
            wz = torch.where(torch.isnan(structure_z), wz,
                             structure_z + sz[lo:hi, None])
        pts = torch.stack([ox, oy, wz - sz[lo:hi, None]], -1)
        points[lo:hi].copy_(pts.to(torch.float32))
        inten[lo:hi].copy_(1.0 + 99.0 * torch.rand(
            (m, n), generator=gen, device=dev))
    pose = torch.stack([rx, ry, gz.to(torch.float64),
                        sz.to(torch.float64)], -1).to(torch.float32).cpu()
    return Scans(points=points, intensity=inten, pose=pose)

