"""A raw Velodyne HDL-64E sweep of n = 64 x n_az returns: 64 lasers (+2 to
-8.33 deg in 1/3 deg steps, -8.83 to -24.33 deg in 1/2 deg steps) times an
azimuth grid.  A laser that meets the ground within `max_range_m` returns
the terrain there; the others return a vertical structure at a range drawn
in [5 m, max_range_m].  Reads `max_range_m`, `sensor_height_m`."""

import math

import torch

ELEVATIONS_DEG = ([2.0 - i / 3.0 for i in range(32)]
                  + [-8.83 - 0.5 * j for j in range(32)])


def pattern(traffic, gen, m, n, dev):
    max_range = float(traffic["max_range_m"])
    sensor_height = float(traffic["sensor_height_m"])
    rings = len(ELEVATIONS_DEG)
    if n % rings:
        raise ValueError(f"hdl64 scans hold a multiple of {rings} points")
    n_az = n // rings
    f64 = dict(generator=gen, device=dev, dtype=torch.float64)
    elev = torch.deg2rad(torch.tensor(ELEVATIONS_DEG, dtype=torch.float64,
                                      device=dev))
    step = 2 * math.pi / n_az
    az = (torch.arange(n_az, dtype=torch.float64, device=dev) * step)[
        None, None, :] + step * (torch.rand((m, rings, n_az), **f64) - 0.5)
    tan = torch.tan(elev)[None, :, None].expand(m, rings, n_az)
    ground_r = sensor_height / torch.clamp(-tan, min=1e-9)
    ground = (tan < 0) & (ground_r <= max_range)
    wall_r = 5.0 + (max_range - 5.0) * torch.rand((m, rings, n_az), **f64)
    r = torch.where(ground, ground_r, wall_r)
    structure_z = torch.where(ground, float("nan"), wall_r * tan)
    flat = lambda a: a.reshape(m, n)
    return (flat(r * torch.cos(az)), flat(r * torch.sin(az)),
            flat(structure_z))
