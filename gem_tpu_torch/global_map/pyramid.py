"""Multi-resolution voxel pyramid: the octomap export.

Counterpart of gem_tpu/global_map/pyramid.py.  The reference thresholds the
composed global cloud by traversability into two ColorOcTrees (road @ 0.2 m,
obstacle @ 0.1 m) after a statistical outlier removal (pointCloudtoOctomap,
src/ElevationMapping.cpp:1146-1174).  Here: rasterise points into a dense
base-level (X, Y, Z) occupancy + color grid anchored at an origin, then
pool upward.  Level 0 is the finest; each level halves every axis.
Occupancy is a scatter-set and color a scatter-max, both order-free, so the
grids do not depend on the device's scatter order.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

_SENTINEL = 2147483647        # masked key of an invalid point


def _div(x, c: float):
    """x / c as a true division, as the reference's eager call computes it;
    the divisor is a tensor because PyTorch's CUDA kernel multiplies by the
    reciprocal of a scalar one."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    occupancy: torch.Tensor   # (X, Y, Z) bool
    color: torch.Tensor       # (X, Y, Z) int32 packed rgb (0 where empty)
    origin: tuple             # world xyz of voxel (0,0,0) corner
    resolution: float


def statistical_outlier_mask(xs, ys, zs, valid, mean_k: int = 20,
                             std_mul: float = 1.0, cell: float = 1.0):
    """Approximate PCL StatisticalOutlierRemoval (meanK=20, stddev=1.0,
    src/ElevationMapping.cpp:1152-1156) with a grid-density criterion:
    points in coarse cells holding fewer points than mean - std_mul * std of
    the per-point density are dropped."""
    qx = torch.floor(_div(xs, cell)).to(torch.int32)
    qy = torch.floor(_div(ys, cell)).to(torch.int32)
    # the reference's int32 key (qx & 0xFFFF) << 16 | (qy & 0xFFFF) wraps;
    # in int64 every key keeps its identity, so the equal-key runs are the
    # same, and invalid points share the sentinel's run
    key = ((qx.to(torch.int64) & 0xFFFF) << 16) | (qy.to(torch.int64)
                                                   & 0xFFFF)
    masked = torch.where(valid, key, _SENTINEL)
    _, inverse, counts = torch.unique(masked, return_inverse=True,
                                      return_counts=True)
    density = counts[inverse].to(torch.int32)
    valid_f = valid.to(torch.float32)
    n = torch.clamp(valid_f.sum(), min=1.0)
    mean = (density * valid_f).sum() / n
    var = ((density - mean) ** 2 * valid_f).sum() / n
    thresh = mean - std_mul * torch.sqrt(var)
    return valid & (density.to(torch.float32) >= thresh)


def rasterize(xs, ys, zs, colors, valid, origin, resolution: float,
              shape) -> VoxelGrid:
    """Scatter a point record into a dense occupancy grid."""
    X, Y, Z = shape
    idx = [torch.floor(_div(v - o, resolution)).to(torch.int64)
           for v, o in zip((xs, ys, zs), origin)]
    ok = valid
    for i, n in zip(idx, shape):
        ok = ok & (i >= 0) & (i < n)
    ix, iy, iz = idx
    flat = torch.where(ok, (ix * Y + iy) * Z + iz, X * Y * Z)
    dev = xs.device
    occ = torch.zeros((X * Y * Z + 1,), dtype=torch.bool, device=dev)
    occ[flat] = True
    col = torch.zeros((X * Y * Z + 1,), dtype=torch.int32, device=dev)
    col.scatter_reduce_(0, flat, colors.to(torch.int32), "amax")
    return VoxelGrid(occupancy=occ[:-1].reshape(X, Y, Z),
                     color=col[:-1].reshape(X, Y, Z),
                     origin=tuple(origin), resolution=resolution)


def _pool2(grid: VoxelGrid) -> VoxelGrid:
    """One pyramid level up: 2x2x2 occupancy-OR / color-max pooling."""
    X, Y, Z = grid.occupancy.shape
    o = grid.occupancy[: X // 2 * 2, : Y // 2 * 2, : Z // 2 * 2]
    c = grid.color[: X // 2 * 2, : Y // 2 * 2, : Z // 2 * 2]
    o = o.reshape(X // 2, 2, Y // 2, 2, Z // 2, 2).any(dim=5).any(dim=3) \
        .any(dim=1)
    c = c.reshape(X // 2, 2, Y // 2, 2, Z // 2, 2).amax(dim=(1, 3, 5))
    return VoxelGrid(occupancy=o, color=c, origin=grid.origin,
                     resolution=grid.resolution * 2)


def build_pyramid(xs, ys, zs, colors, travers, valid, *,
                  origin, base_resolution: float, shape,
                  travers_threshold: float, levels: int = 3,
                  outlier_filter: bool = True):
    """Road/obstacle voxel pyramids split by traversability
    (road: travers > threshold; obstacle: travers <= threshold), each
    `levels` deep.  Returns (road_levels, obstacle_levels)."""
    if outlier_filter:
        valid = statistical_outlier_mask(xs, ys, zs, valid)
    road = valid & (travers > travers_threshold)
    obs = valid & (travers <= travers_threshold)

    def levels_of(mask):
        g = rasterize(xs, ys, zs, colors, mask, origin, base_resolution,
                      shape)
        out: List[VoxelGrid] = [g]
        for _ in range(levels - 1):
            g = _pool2(g)
            out.append(g)
        return out

    return levels_of(road), levels_of(obs)
