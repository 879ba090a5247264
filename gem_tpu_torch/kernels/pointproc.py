"""Per-point processing: colorize, transform, filter, variance, bin.

Counterpart of gem_tpu/kernels/pointproc.py (G_pointsprocess plus the
per-frame colorization loop), over a fixed-size padded point batch with a
validity mask.

`lowest_bound` is the per-cell lowest-scan bound that the segment, sort
and pallas fuse backends apply (kernels/fuse.py; the stream fuse reads the
same winner off its sorted run ends, kernels/fuse_stream.py).  As in the
reference, `lowest` is indexed by GEOGRAPHIC cell, unlike every other
plane.

Every input may carry a leading robot axis (points (R, P, 3), transforms
(R, 4, 4), images (R, H, W, 3), planes (R, L, L)): cell ids stay local to
each robot (< L*L), and each robot's points are colorized from its own
image.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gem_tpu_torch.core import index_math as im
from gem_tpu_torch.core.state import MapState, pack_rgb
from gem_tpu_torch.sensors.models import height_variance
from gem_tpu_torch.utils.device import constant


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """Processed points ready for fusion; all (..., P) / (..., P, k) fixed
    shapes."""

    xy: torch.Tensor         # (P, 2) map-frame position
    height: torch.Tensor     # (P,) map-frame z
    variance: torch.Tensor   # (P,) propagated height variance
    cell: torch.Tensor       # (P,) int32 flat storage cell id, L*L if invalid
    color: torch.Tensor      # (P,) int32 packed rgb (0 when no color)
    intensity: torch.Tensor  # (P,)
    valid: torch.Tensor      # (P,) bool


def _affine(points, m, t=None):
    """points (..., N, 3) @ m.T (+ t), with m (..., 3, 3) and t (..., 3),
    written out as exact fp32 products and sums (no matmul, so no TF32 and
    the same bits on CPU and CUDA)."""
    m = m[..., None, :, :]
    out = (points[..., 0:1] * m[..., 0] + points[..., 1:2] * m[..., 1]
           + points[..., 2:3] * m[..., 2])
    return out if t is None else out + t[..., None, :]


def project_to_image(points, projection):
    """Pinhole projection of sensor-frame points: (u, v, depth) floats."""
    P = constant(tuple(float(x) for x in np.ravel(projection)),
                 str(points.device)).reshape(3, 4)
    img_pt = _affine(points, P[:, :3], P[:, 3])
    z = img_pt[..., 2]
    zs = torch.where(z == 0, 1e-9, z)
    return img_pt[..., 0] / zs, img_pt[..., 1] / zs, z


def colorize(points, image, projection):
    """Nearest-pixel rgb where the projection lands strictly inside the
    image with z > 0, else 0: points (..., N, 3), one image (..., H, W, 3)
    per leading index.  Returns (packed rgb, ok)."""
    H, W = image.shape[-3], image.shape[-2]
    u, v, z = project_to_image(points, projection)
    ui = u.to(torch.int32)
    vi = v.to(torch.int32)
    ok = (ui > 0) & (ui < W) & (vi > 0) & (vi < H) & (z > 0)
    ui = torch.clamp(ui, 0, W - 1)
    vi = torch.clamp(vi, 0, H - 1)
    flat = image.flatten(-3, -2).to(torch.int32)          # (..., H*W, 3)
    pix = (vi * W + ui).long()[..., None].expand(ui.shape + (3,))
    rgb = flat.gather(-2, pix)
    zero = torch.zeros_like(rgb[..., 0])
    r = torch.where(ok, rgb[..., 0], zero)
    g = torch.where(ok, rgb[..., 1], zero)
    b = torch.where(ok, rgb[..., 2], zero)
    return pack_rgb(r, g, b), ok


def _body_filter(cfg, points):
    """Sensor-frame self/FOV rejection (True = drop); `reference` mode is
    the hard-coded box of gpu_process.cu:393."""
    bf = cfg.body_filter
    x, y = points[..., 0], points[..., 1]
    if bf.mode == "none":
        return torch.zeros(points.shape[:-1], dtype=torch.bool,
                           device=points.device)
    in_body = ((x > -bf.body_half_x) & (x < bf.body_half_x)
               & (y > -bf.body_half_y) & (y < bf.body_half_y))
    if bf.mode == "box":
        return in_body
    return in_body | ((y > -1.0) & (y < 1.0)) | (y > 0.0)


def lowest_bound(lowest, geo_cell, height, var, valid, L: int):
    """min(lowest, per-geographic-cell bound): the cell's winner is its
    minimum h and, among exact-h ties, the maximum v; its bound is h + 3v.
    `lowest` is (..., L, L) and the points (..., P), one plane per leading
    index.

    JAX takes the winner off a 3-key sort by (geo_cell, h, -v) and computes
    h - 3 * (-v), which is bitwise h + 3v.  Here two order-free reductions
    pick the same winner: amin of h, then amax of v over the lanes whose h
    equals that min (== treats -0.0 and +0.0 as equal, as lax.sort does).
    Robot r's cells are folded to r * (L*L + 1) + cell, so one reduction
    serves every robot and each keeps its own dump cell."""
    lead = lowest.shape[:-2]
    nrob = math.prod(lead)
    S = L * L + 1
    base = (torch.arange(nrob, device=height.device) * S).reshape(
        lead + (1,))
    ids = (torch.where(valid, geo_cell.to(torch.int64), L * L)
           + base).reshape(-1)
    inf = float("inf")
    h_s = torch.where(valid, height, inf).reshape(-1)
    hmin = torch.full((nrob * S,), inf, device=height.device)
    hmin.scatter_reduce_(0, ids, h_s, "amin")
    tie = valid.reshape(-1) & (height.reshape(-1) == hmin[ids])
    vmax = torch.full((nrob * S,), -inf, device=height.device)
    vmax.scatter_reduce_(0, ids, torch.where(tie, var.reshape(-1), -inf),
                         "amax")
    hmin = hmin.reshape(lead + (S,))[..., :L * L]
    vmax = vmax.reshape(lead + (S,))[..., :L * L]
    cand = torch.where(hmin < inf, hmin + 3.0 * vmax, inf)
    return torch.minimum(lowest.flatten(-2), cand).reshape(lowest.shape)


def process_points(state: MapState, cfg, points, intensity, in_valid,
                   transform, base_z, sensor_jacobian, rotation_variance,
                   c_sb_t, p_mul_c_bm_t, b_r_bs_skew, image=None,
                   colors=None) -> PointBatch:
    """The processed PointBatch."""
    L = cfg.map.length
    points = points.to(torch.float32)
    T = transform.to(torch.float32)

    # sensor -> map transform, exact fp32
    ts = _affine(points, T[..., :3, :3], T[..., :3, 3])
    height = ts[..., 2]

    if image is not None and cfg.camera.image_height > 0:
        color, _ = colorize(points, image, cfg.camera.projection)
    elif colors is not None:
        color = colors.to(torch.int32)
    else:
        color = torch.zeros(points.shape[:-1], dtype=torch.int32,
                            device=points.device)

    drop = _body_filter(cfg, points)
    base_z = base_z[..., None]
    lower = base_z + cfg.sensor.ignore_points_below
    upper = base_z + cfg.sensor.ignore_points_above
    valid = in_valid.to(torch.bool) & ~drop & (height > lower) \
        & (height < upper)
    if cfg.sensor.model == "structured_light":
        depth = points[..., 2]
        valid = valid & (depth >= cfg.sensor.cutoff_min_depth) \
            & (depth <= cfg.sensor.cutoff_max_depth)

    pixel_uv = None
    if cfg.sensor.model == "stereo" and cfg.camera.image_height > 0:
        u, v, _ = project_to_image(points, cfg.camera.projection)
        pixel_uv = torch.stack([u, v], dim=-1)
    var = height_variance(cfg.sensor, points, sensor_jacobian,
                          rotation_variance, c_sb_t, p_mul_c_bm_t,
                          b_r_bs_skew, pixel_uv=pixel_uv)

    gx, gy, in_map = im.position_to_geo_index(
        ts[..., 0], ts[..., 1], state.center[..., None, :], L,
        cfg.map.resolution)
    valid = valid & in_map
    sx, sy = im.geo_to_storage(gx, gy, state.start[..., None, :], L)
    cell = torch.where(valid, sx * L + sy, L * L).to(torch.int32)
    return PointBatch(xy=ts[..., :2], height=height, variance=var,
                      cell=cell, color=color,
                      intensity=intensity.to(torch.float32), valid=valid)
