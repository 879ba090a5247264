"""The intake of an organized cloud as upstream takes it: a depth camera's
cloud keeps a lane for every pixel, NaN where the pixel has no depth, and
`SensorProcessorBase::cleanPointCloud` (pcl::removeNaNFromPointCloud)
removes every point with a non-finite coordinate, keeping the others in
pixel order.  The cleaned cloud is then padded to the fixed frame size
with zero points that are not valid, as the reference's frames are."""

from __future__ import annotations

import torch


def clean(points, intensity, max_points: int):
    """(points (max_points, 3), intensity (max_points,), valid
    (max_points,) bool): the finite points of an organized cloud (points
    (n, 3), intensity (n,)) in their order, then zero padding."""
    keep = torch.isfinite(points).all(dim=-1)
    pts, inten = points[keep], intensity[keep]
    count = pts.shape[0]
    if count > max_points:
        raise ValueError(f"{count} finite points exceed max_points "
                         f"{max_points}")
    out_p = torch.zeros((max_points, 3), dtype=points.dtype,
                        device=points.device)
    out_i = torch.zeros((max_points,), dtype=intensity.dtype,
                        device=intensity.device)
    out_p[:count] = pts
    out_i[:count] = inten
    valid = torch.arange(max_points, device=points.device) < count
    return out_p, out_i, valid
