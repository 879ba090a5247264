"""The reference's intake: the upstream voxel-grid pre-filter
(filter_kitti.launch's VoxelGrid + crop box) and the padding of a raw scan
into a fixed-size frame, in NumPy.

`voxel_filter` keeps the semantics of the port's host runtime: crop box
tested in float32 against float32 bounds, NaN points dropped, cells keyed
by floor(x * (1 / leaf)) in float64 with leaf as float32, each cell's
centroid and mean intensity summed in float64 in input order and rounded
to float32.  Its output order is the sorted cell keys (the host runtime's
is its hash table's), so outputs are compared as sets.  With the control
on (`precision.TF32`) the sums run in float32, the step below float64.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import precision
from benchmark.reference.pipeline import Frame


def voxel_filter(points, intensity, leaf, crop):
    """(points (m, 3) float32, intensity (m,) float32) of the cells' means."""
    pts = np.ascontiguousarray(points, np.float32)
    inten = np.ascontiguousarray(intensity, np.float32)
    (x0, x1), (y0, y1), (z0, z1) = [tuple(np.float32(a) for a in c)
                                    for c in crop]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    keep = ((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1) & (z >= z0)
            & (z <= z1) & ~np.isnan(pts).any(axis=1))
    pts, inten = pts[keep], inten[keep]
    inv = 1.0 / np.float64(np.float32(leaf))
    ijk = np.floor(pts.astype(np.float64) * inv).astype(np.int64) + 2 ** 20
    keys = (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]
    _, cell, counts = np.unique(keys, return_inverse=True,
                                return_counts=True)
    cols = [pts[:, 0], pts[:, 1], pts[:, 2], inten]
    if precision.TF32:
        sums = []
        for c in cols:
            s = np.zeros(len(counts), np.float32)
            np.add.at(s, cell, c)
            sums.append(s / counts.astype(np.float32))
        means = [s.astype(np.float32) for s in sums]
    else:
        means = [(np.bincount(cell, weights=c.astype(np.float64),
                              minlength=len(counts)) / counts)
                 .astype(np.float32) for c in cols]
    return np.stack(means[:3], -1), means[3]


def pad_frame(cfg, points, intensity, transform, track_position, device
              ) -> Frame:
    """A raw scan through the pre-filter, padded to cfg.max_points (every
    other field as the upstream demo leaves it: identity extrinsics, zero
    pose covariance, no color, no loop closure)."""
    pf = cfg.prefilter
    if pf.leaf > 0:
        points, intensity = voxel_filter(
            points, intensity, pf.leaf, (pf.crop_x, pf.crop_y, pf.crop_z))
    P = cfg.max_points
    n = min(len(points), P)
    pts = np.zeros((P, 3), np.float32)
    pts[:n] = points[:n]
    valid = np.zeros((P,), bool)
    valid[:n] = True
    inten = np.zeros((P,), np.float32)
    inten[:n] = intensity[:n]
    track = np.asarray(track_position, np.float32)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return Frame(
        points=t(pts), intensity=t(inten), valid=t(valid),
        transform=t(np.asarray(transform, np.float32)),
        r_base_sensor=t(np.eye(3, dtype=np.float32)),
        t_base_sensor=t(np.zeros(3, np.float32)),
        r_map_base=t(np.eye(3, dtype=np.float32)),
        t_map_base=t(track), track_position=t(track),
        pose_quat=t(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)),
        pose_cov=t(np.zeros((6, 6), np.float32)),
        colors=t(np.zeros((P,), np.int32)), image=None,
        loop_closure=t(np.zeros((), bool)))
