"""Per-point processing: colorize, transform, filter, variance, bin.

Counterpart of gem_tpu/kernels/pointproc.py (G_pointsprocess plus the
per-frame colorization loop), over a fixed-size padded point batch with a
validity mask.

It also computes the per-cell lowest-scan bound that the segment, sort and
pallas fuse backends need (the stream fuse reads the same winner off its
sorted run ends, kernels/fuse_stream.py).  As in the reference, `lowest`
is indexed by GEOGRAPHIC cell, unlike every other plane.
"""

from __future__ import annotations

import dataclasses

import torch

from gem_tpu_torch.core import index_math as im
from gem_tpu_torch.core.state import MapState, pack_rgb
from gem_tpu_torch.sensors.models import height_variance


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """Processed points ready for fusion; all (P,) / (P, k) fixed shapes."""

    xy: torch.Tensor         # (P, 2) map-frame position
    height: torch.Tensor     # (P,) map-frame z
    variance: torch.Tensor   # (P,) propagated height variance
    cell: torch.Tensor       # (P,) int32 flat storage cell id, L*L if invalid
    color: torch.Tensor      # (P,) int32 packed rgb (0 when no color)
    intensity: torch.Tensor  # (P,)
    valid: torch.Tensor      # (P,) bool


def _affine(points, m, t=None):
    """points (N, 3) @ m.T (+ t), written out as exact fp32 products and
    sums (no matmul, so no TF32 and the same bits on CPU and CUDA)."""
    out = (points[:, 0:1] * m[:, 0] + points[:, 1:2] * m[:, 1]
           + points[:, 2:3] * m[:, 2])
    return out if t is None else out + t


def project_to_image(points, projection):
    """Pinhole projection of sensor-frame points: (u, v, depth) floats."""
    P = torch.as_tensor(projection, dtype=torch.float32,
                        device=points.device).reshape(3, 4)
    img_pt = _affine(points, P[:, :3], P[:, 3])
    z = img_pt[:, 2]
    zs = torch.where(z == 0, 1e-9, z)
    return img_pt[:, 0] / zs, img_pt[:, 1] / zs, z


def colorize(points, image, projection):
    """Nearest-pixel rgb where the projection lands strictly inside the
    image with z > 0, else 0.  Returns (packed rgb, ok)."""
    H, W = image.shape[0], image.shape[1]
    u, v, z = project_to_image(points, projection)
    ui = u.to(torch.int32)
    vi = v.to(torch.int32)
    ok = (ui > 0) & (ui < W) & (vi > 0) & (vi < H) & (z > 0)
    ui = torch.clamp(ui, 0, W - 1)
    vi = torch.clamp(vi, 0, H - 1)
    flat = image.reshape(-1, image.shape[-1]).to(torch.int32)
    rgb = flat[(vi * W + ui).long()]
    zero = torch.zeros_like(rgb[:, 0])
    r = torch.where(ok, rgb[:, 0], zero)
    g = torch.where(ok, rgb[:, 1], zero)
    b = torch.where(ok, rgb[:, 2], zero)
    return pack_rgb(r, g, b), ok


def _body_filter(cfg, points):
    """Sensor-frame self/FOV rejection (True = drop); `reference` mode is
    the hard-coded box of gpu_process.cu:393."""
    bf = cfg.body_filter
    x, y = points[:, 0], points[:, 1]
    if bf.mode == "none":
        return torch.zeros(points.shape[0], dtype=torch.bool,
                           device=points.device)
    in_body = ((x > -bf.body_half_x) & (x < bf.body_half_x)
               & (y > -bf.body_half_y) & (y < bf.body_half_y))
    if bf.mode == "box":
        return in_body
    return in_body | ((y > -1.0) & (y < 1.0)) | (y > 0.0)


def lowest_bound(lowest, geo_cell, height, var, valid, L: int):
    """min(lowest, per-geographic-cell bound): the cell's winner is its
    minimum h and, among exact-h ties, the maximum v; its bound is h + 3v.

    JAX takes the winner off a 3-key sort by (geo_cell, h, -v) and computes
    h - 3 * (-v), which is bitwise h + 3v.  Here two order-free reductions
    pick the same winner: amin of h, then amax of v over the lanes whose h
    equals that min (== treats -0.0 and +0.0 as equal, as lax.sort does)."""
    ids = torch.where(valid, geo_cell.to(torch.int64), L * L)
    inf = float("inf")
    h_s = torch.where(valid, height, inf)
    hmin = torch.full((L * L + 1,), inf, device=height.device)
    hmin.scatter_reduce_(0, ids, h_s, "amin")
    tie = valid & (height == hmin[ids])
    vmax = torch.full((L * L + 1,), -inf, device=height.device)
    vmax.scatter_reduce_(0, ids, torch.where(tie, var, -inf), "amax")
    hmin, vmax = hmin[:L * L], vmax[:L * L]
    cand = torch.where(hmin < inf, hmin + 3.0 * vmax, inf)
    return torch.minimum(lowest.reshape(-1), cand).reshape(L, L)


def process_points(state: MapState, cfg, points, intensity, in_valid,
                   transform, base_z, sensor_jacobian, rotation_variance,
                   c_sb_t, p_mul_c_bm_t, b_r_bs_skew, image=None,
                   colors=None, compute_lowest=True):
    """Returns the processed PointBatch and the updated (geographic) lowest
    plane; with `compute_lowest=False` (the stream fuse owns the reduction)
    the plane comes back unchanged."""
    L = cfg.map.length
    points = points.to(torch.float32)
    T = transform.to(torch.float32)

    # sensor -> map transform, exact fp32
    ts = _affine(points, T[:3, :3], T[:3, 3])
    height = ts[:, 2]

    if image is not None and cfg.camera.image_height > 0:
        color, _ = colorize(points, image, cfg.camera.projection)
    elif colors is not None:
        color = colors.to(torch.int32)
    else:
        color = torch.zeros(points.shape[0], dtype=torch.int32,
                            device=points.device)

    drop = _body_filter(cfg, points)
    lower = base_z + cfg.sensor.ignore_points_below
    upper = base_z + cfg.sensor.ignore_points_above
    valid = in_valid.to(torch.bool) & ~drop & (height > lower) \
        & (height < upper)
    if cfg.sensor.model == "structured_light":
        depth = points[:, 2]
        valid = valid & (depth >= cfg.sensor.cutoff_min_depth) \
            & (depth <= cfg.sensor.cutoff_max_depth)

    pixel_uv = None
    if cfg.sensor.model == "stereo" and cfg.camera.image_height > 0:
        u, v, _ = project_to_image(points, cfg.camera.projection)
        pixel_uv = torch.stack([u, v], dim=-1)
    var = height_variance(cfg.sensor, points, sensor_jacobian,
                          rotation_variance, c_sb_t, p_mul_c_bm_t,
                          b_r_bs_skew, pixel_uv=pixel_uv)

    gx, gy, in_map = im.position_to_geo_index(ts[:, 0], ts[:, 1],
                                              state.center, L,
                                              cfg.map.resolution)
    valid = valid & in_map
    sx, sy = im.geo_to_storage(gx, gy, state.start, L)
    cell = torch.where(valid, sx * L + sy, L * L).to(torch.int32)
    lowest = state.lowest
    if cfg.enable_lowest and compute_lowest:
        lowest = lowest_bound(lowest, gx * L + gy, height, var, valid, L)

    batch = PointBatch(xy=ts[:, :2], height=height, variance=var, cell=cell,
                       color=color, intensity=intensity.to(torch.float32),
                       valid=valid)
    return batch, lowest
