"""Render products: costmap layers, orthomosaic, heatmap, colored cloud.

Counterpart of gem_tpu/render/products.py; pure functions of the state,
tensors in, tensors out, on the state's device:

  * costmap_from_traversability  <- ElevationMapLayer: traver below the
    threshold is LETHAL, else FREE, unknown NO_INFORMATION;
  * costmap_from_points          <- PointMapLayer, rasterising a record;
  * distance_to_lethal, inflate_costmap <- the move_base InflationLayer;
  * orthomosaic, elevation_heatmap <- ElevationMap::show's renders,
    geographic-aligned;
  * grid_point_cloud             <- gridMaptoPointCloud.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import index_math as im
from benchmark.reference.state import MapState, unpack_rgb
from benchmark.reference.precision import f32_recip

# costmap_2d cost values (costmap_2d/cost_values.h convention)
FREE_SPACE = 0
LETHAL_OBSTACLE = 254
NO_INFORMATION = 255
INSCRIBED_INFLATED = 253


def costmap_from_traversability(traver, threshold: float,
                                invalid: float = -10.0, start=None):
    """(L, L) uint8 costmap from a traversability plane; with `start` it is
    emitted geographic-aligned (needed before inflate_costmap)."""
    known = traver != invalid
    lethal = known & (traver < threshold)
    cm = torch.where(lethal, LETHAL_OBSTACLE,
                     torch.where(known, FREE_SPACE, NO_INFORMATION)
                     ).to(torch.uint8)
    return cm if start is None else im.roll_to_geo(cm, start)


def costmap_from_points(xs, ys, travers, valid, threshold: float,
                        origin_xy, resolution: float, size: int):
    """Rasterise a point record into a (size, size) costmap whose (0, 0)
    corner sits at `origin_xy`.  Duplicate cells combine by max (LETHAL
    beats FREE), so the result does not depend on point order."""
    inv = f32_recip(resolution)
    # floor, not truncation: points just below the origin fall outside
    ix = torch.floor((xs - origin_xy[0]) * inv).to(torch.int64)
    iy = torch.floor((ys - origin_xy[1]) * inv).to(torch.int64)
    ok = valid & (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
    flat = torch.where(ok, ix * size + iy, size * size)
    cost = torch.where(travers > threshold, FREE_SPACE, LETHAL_OBSTACLE)
    grid = torch.full((size * size + 1,), -1, dtype=torch.int32,
                      device=xs.device)
    grid.scatter_reduce_(0, flat, cost.to(torch.int32), "amax")
    grid = torch.where(grid < 0, NO_INFORMATION, grid)
    return grid[:-1].reshape(size, size).to(torch.uint8)


def distance_to_lethal(costmap, max_radius_cells: int):
    """Euclidean distance (in cells) from each cell to the nearest LETHAL
    cell, clamped at max_radius_cells + 1: a separable min-plus sweep along
    columns, then rows.  Shifts are edge-filled, not circular."""
    lethal = costmap == LETHAL_OBSTACLE
    r = int(max_radius_cells)
    L0, L1 = lethal.shape
    inf = float((r + 1) ** 2)
    src = torch.where(lethal, 0.0, inf).to(torch.float32)
    padded = F.pad(src, (r, r), value=inf)
    d1 = src
    for j in range(-r, r + 1):
        if j:
            d1 = torch.minimum(d1, padded[:, r + j:r + j + L1] + j * j)
    padded = F.pad(d1, (0, 0, r, r), value=inf)
    d2 = d1
    for i in range(-r, r + 1):
        if i:
            d2 = torch.minimum(d2, padded[r + i:r + i + L0, :] + i * i)
    return torch.sqrt(torch.clamp(d2, max=inf))


def inflate_costmap(costmap, radius_cells, cost_scaling_factor: float = 0.0,
                    resolution: float = 1.0, inscribed_radius: float = 0.0):
    """move_base InflationLayer semantics: d <= inscribed_radius ->
    INSCRIBED_INFLATED; inscribed < d <= radius -> 252 exp(-k (d -
    inscribed)); beyond, untouched; unknown cells stay unknown.  `d` is the
    Euclidean distance to the nearest lethal cell in metres."""
    r = int(math.ceil(radius_cells))
    if r <= 0:
        return costmap.to(torch.uint8)
    dist_m = distance_to_lethal(costmap, r) * resolution
    radius_m = radius_cells * resolution
    in_inscribed = dist_m <= inscribed_radius
    in_radius = dist_m <= radius_m
    if cost_scaling_factor > 0.0:
        ramp = ((INSCRIBED_INFLATED - 1) * torch.exp(
            -cost_scaling_factor
            * torch.clamp(dist_m - inscribed_radius, min=0.0))
                ).to(torch.int32)
    else:
        ramp = torch.full(dist_m.shape, INSCRIBED_INFLATED,
                          dtype=torch.int32, device=dist_m.device)
    inflated = torch.where(in_inscribed, INSCRIBED_INFLATED,
                           torch.where(in_radius, ramp, 0))
    base = costmap.to(torch.int32)
    out = torch.where(base != NO_INFORMATION, torch.maximum(base, inflated),
                      base)
    return out.to(torch.uint8)


def orthomosaic(state: MapState, cfg, traver=None):
    """(L, L, 3) uint8 top-down RGB, geographic-aligned; empty cells black
    (`cfg` is a MapConfig).  A state with a robot axis gives (R, L, L, 3),
    each robot rolled by its own start."""
    valid = state.elevation != cfg.invalid_elevation
    if traver is not None:
        valid = valid & (traver != cfg.invalid_traversability)
    img = torch.stack(unpack_rgb(state.color), dim=-1)
    img = torch.where(valid[..., None], img, 0).to(torch.uint8)
    return im.roll_to_geo(img, state.start)


def elevation_heatmap(state: MapState, cfg, vmin=None, vmax=None):
    """(L, L, 3) uint8 geographic-aligned elevation colormap (blue=low,
    red=high, black=empty)."""
    elev = state.elevation
    valid = elev != cfg.invalid_elevation
    big = 1e9
    lo = torch.where(valid, elev, big).min() if vmin is None else vmin
    hi = torch.where(valid, elev, -big).max() if vmax is None else vmax
    span = hi - lo
    span = torch.clamp(span, min=1e-6) if isinstance(span, torch.Tensor) \
        else max(span, 1e-6)
    t = torch.clamp((elev - lo) / span, 0.0, 1.0)
    r = torch.clamp(1.5 * t - 0.25, 0, 1)
    g = 1.0 - torch.abs(2.0 * t - 1.0) * 0.8
    b = torch.clamp(1.25 - 1.5 * t, 0, 1)
    img = torch.stack([r, g, b], dim=-1) * 255.0
    img = torch.where(valid[..., None], img, 0.0).to(torch.uint8)
    return im.roll_to_geo(img, state.start)


def grid_point_cloud(state: MapState, cfg, traver=None):
    """Struct-of-arrays colored cloud of the live grid: dict of (L*L,)
    tensors with a validity mask (compaction is the caller's)."""
    L = cfg.length
    g = torch.arange(L, device=state.elevation.device, dtype=torch.int32)
    gx, gy = im.storage_to_geo(g.repeat_interleave(L), g.repeat(L),
                               state.start, L)
    px, py = im.geo_index_to_position(gx, gy, state.center, L,
                                      cfg.resolution)
    elev = state.elevation.reshape(-1)
    valid = elev != cfg.invalid_elevation
    tr = (traver if traver is not None else state.traver).reshape(-1)
    if traver is not None:
        valid = valid & (tr != cfg.invalid_traversability)
    r, g_, b = unpack_rgb(state.color.reshape(-1))
    return dict(x=px, y=py, z=elev, r=r, g=g_, b=b,
                intensity=state.intensity.reshape(-1),
                variance=state.variance.reshape(-1), traver=tr, valid=valid)
