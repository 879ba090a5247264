"""The port's synthetic scan (`_scan_pattern` of gem_tpu_torch/io/replay.py):
uniform azimuth, ranges r = min + (max - min) u^1.5, biased to the near
field; every point hits the terrain.  Reads `min_range_m`, `max_range_m`."""

import math

import torch


def pattern(traffic, gen, m, n, dev):
    min_range = float(traffic["min_range_m"])
    max_range = float(traffic["max_range_m"])
    f64 = dict(generator=gen, device=dev, dtype=torch.float64)
    az = 2 * math.pi * torch.rand((m, n), **f64)
    r = min_range + (max_range - min_range) * torch.rand((m, n), **f64) ** 1.5
    return r * torch.cos(az), r * torch.sin(az), None
