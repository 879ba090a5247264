"""An Intel RealSense D435's organized depth image on flat ground: one
width x height pinhole camera (principal point at the centre, the depth
field of view `hfov_deg` x `vfov_deg`) per scan, the cameras of
`camera_yaws_deg` in turn, each pitched `pitch_deg` down and
`sensor_height_m` above the ground.  Scan j of a call is camera j % C's, C
the number of cameras: `frames.make_scans` calls in chunks that start at
multiples of 64, so frame g is camera g % C's where C divides 64.

Each pixel, in row-major order (v, then u), returns its ray's flat-ground
offset from the camera in world-aligned axes; NaN (no depth) where the ray
meets no ground within `max_range_m` along it, and for a `hole_share` of
the pixels drawn from the seed.  `make_scans` puts the terrain height under
each offset and turns a NaN offset into a NaN point.

The optical frame is x right, y down, z along the view; `rotations` gives
each camera's base-from-optical rotation (columns: the optical axes in the
world-aligned base frame), which the feed uses to hand the points over in
the camera's own frame."""

import math

import torch


def rotation(yaw_deg: float, pitch_deg: float) -> torch.Tensor:
    """(3, 3) float64: columns x (right), y (down), z (view) of a camera
    looking along yaw, pitched down by pitch."""
    yaw, pitch = math.radians(yaw_deg), math.radians(pitch_deg)
    view = torch.tensor([math.cos(pitch) * math.cos(yaw),
                         math.cos(pitch) * math.sin(yaw), -math.sin(pitch)],
                        dtype=torch.float64)
    right = torch.tensor([math.sin(yaw), -math.cos(yaw), 0.0],
                         dtype=torch.float64)
    down = torch.linalg.cross(view, right)
    return torch.stack([right, down, view], dim=1)


def rotations(traffic) -> torch.Tensor:
    """(C, 3, 3) float64: each camera's base-from-optical rotation."""
    pitch = float(traffic["pitch_deg"])
    return torch.stack([rotation(float(y), pitch)
                        for y in traffic["camera_yaws_deg"]])


def optical_rays(traffic, dev) -> torch.Tensor:
    """(H * W, 3) float64: each pixel's ray (u, v through the pixel's
    centre, z = 1) in the optical frame, row-major."""
    W, H = int(traffic["width"]), int(traffic["height"])
    fx = (W / 2) / math.tan(math.radians(float(traffic["hfov_deg"])) / 2)
    fy = (H / 2) / math.tan(math.radians(float(traffic["vfov_deg"])) / 2)
    f64 = dict(dtype=torch.float64, device=dev)
    x = (torch.arange(W, **f64) + 0.5 - W / 2) / fx
    y = (torch.arange(H, **f64) + 0.5 - H / 2) / fy
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], -1).reshape(-1, 3)


def pattern(traffic, gen, m, n, dev):
    W, H = int(traffic["width"]), int(traffic["height"])
    if n != W * H:
        raise ValueError(f"d435 scans hold width x height = {W * H} "
                         f"points, not {n}")
    height = float(traffic["sensor_height_m"])
    max_range = float(traffic["max_range_m"])
    rots = rotations(traffic).to(dev)
    cam = torch.arange(m, device=dev) % rots.shape[0]
    r = rots[cam]                                      # (m, 3, 3)
    d = optical_rays(traffic, dev)                     # (n, 3)
    # world ray = R d, written out per axis: (m, n) each
    wx, wy, wz = (d[None, :, 0] * r[:, k, None, 0]
                  + d[None, :, 1] * r[:, k, None, 1]
                  + d[None, :, 2] * r[:, k, None, 2] for k in range(3))
    t = height / torch.clamp(-wz, min=1e-12)
    length = t * torch.sqrt(wx * wx + wy * wy + wz * wz)
    hole = torch.rand((m, n), generator=gen, device=dev,
                      dtype=torch.float64) < float(traffic["hole_share"])
    ok = (wz < 0) & (length <= max_range) & ~hole
    nan = torch.full_like(wx, float("nan"))
    return torch.where(ok, t * wx, nan), torch.where(ok, t * wy, nan), None
