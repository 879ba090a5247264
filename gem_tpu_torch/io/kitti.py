# A copy of gem_tpu/io/kitti.py (the port reads nothing under gem_tpu/).
"""KITTI raw -> npz frame converter.

The reference's KITTI demo replays a rosbag through a VoxelGrid chain with
camera intrinsics from kitti_intrinsic.yaml (kitti_demo.launch,
filter_kitti.launch).  Zero-egress images have no bags; this converter takes
a KITTI raw drive directory

    <drive>/velodyne_points/data/0000000000.bin   (N, 4) float32 x y z r
    <drive>/oxts/data/0000000000.txt              GPS/IMU rows
    <drive>/image_02/data/0000000000.png          (optional, colorization)
    calib: P_rect_02 (3,4), R_rect_00 (3,3), Tr_velo_to_cam (3,4)

and writes the npz frame schema of io/replay.load_npz_frame, with poses
derived from OXTS via the standard mercator projection.
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np

EARTH_RADIUS = 6378137.0


def read_velodyne_bin(path: str):
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw[:, :3], raw[:, 3]


def oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale=None):
    """OXTS row -> (t, R) in the mercator-projected world frame (the
    standard KITTI devkit convention)."""
    if scale is None:
        scale = math.cos(lat * math.pi / 180.0)
    tx = scale * lon * math.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * math.log(
        math.tan((90.0 + lat) * math.pi / 360.0))
    t = np.asarray([tx, ty, alt], np.float64)
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    Rx = np.asarray([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.asarray([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.asarray([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return t, Rz @ Ry @ Rx


def rotmat_to_quat(R):
    """(3,3) -> wxyz."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.asarray([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                           (R[0, 2] - R[2, 0]) / s,
                           (R[1, 0] - R[0, 1]) / s], np.float32)
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q.astype(np.float32)


def read_calib(path: str) -> dict:
    """Parse a KITTI calib text file of `KEY: v v v ...` rows."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.asarray(
                    [float(v) for v in vals.split()], np.float64)
            except ValueError:
                continue
    return out


def projection_matrix(calib: dict):
    """lidar -> image (3, 4): P_rect @ R_rect @ Tr_velo_to_cam — the
    Tcamera*TLidar product the reference reads per frame
    (src/ElevationMapping.cpp:337-343)."""
    P = calib["P_rect_02"].reshape(3, 4)
    R = np.eye(4)
    R[:3, :3] = calib["R_rect_00"].reshape(3, 3)
    Tr = np.eye(4)
    Tr[:3, :4] = calib["Tr_velo_to_cam"].reshape(3, 4)
    return (P @ R @ Tr).astype(np.float32)


def _load_image(path: str):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def convert_drive(drive_dir: str, out_dir: str, max_frames: int = 0,
                  imu_to_velo=None, calib_path: str | None = None,
                  with_images: bool = True) -> int:
    """Convert a KITTI raw drive to npz frames; returns the frame count.

    The sensor->map transform chains OXTS pose with the (optional)
    imu->velodyne extrinsic; the track point follows the velodyne origin.
    When `with_images` and image_02 frames exist, each npz carries the RGB
    image for in-pipeline colorization, and `calib_path` (if given) emits
    `<out_dir>/camera.npz` with the lidar->image projection + image size for
    CameraConfig (CLI: `gem_tpu run --camera <out_dir>/camera.npz`).
    """
    os.makedirs(out_dir, exist_ok=True)
    bins = sorted(glob.glob(os.path.join(drive_dir, "velodyne_points",
                                         "data", "*.bin")))
    oxts = sorted(glob.glob(os.path.join(drive_dir, "oxts", "data", "*.txt")))
    imgs = sorted(glob.glob(os.path.join(drive_dir, "image_02", "data",
                                         "*.png"))) if with_images else []
    if max_frames:
        bins, oxts = bins[:max_frames], oxts[:max_frames]
        imgs = imgs[:max_frames]
    if len(bins) != len(oxts) or not bins:
        raise FileNotFoundError(
            f"bad drive layout under {drive_dir}: "
            f"{len(bins)} scans vs {len(oxts)} oxts rows")
    use_images = len(imgs) == len(bins)

    img_shape = None
    scale = None
    origin = None
    T_iv = np.eye(4) if imu_to_velo is None else np.asarray(imu_to_velo)
    for i, (bpath, opath) in enumerate(zip(bins, oxts)):
        pts, intensity = read_velodyne_bin(bpath)
        row = np.loadtxt(opath)
        lat, lon, alt, roll, pitch, yaw = row[:6]
        if scale is None:
            scale = math.cos(lat * math.pi / 180.0)
        t, R = oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale)
        if origin is None:
            origin = t.copy()
        t = t - origin

        T_wi = np.eye(4)
        T_wi[:3, :3] = R
        T_wi[:3, 3] = t
        T_wv = T_wi @ np.linalg.inv(T_iv)          # world <- velodyne

        extra = {}
        if use_images:
            img = _load_image(imgs[i])
            img_shape = img.shape
            extra["image"] = img
        np.savez(os.path.join(out_dir, f"{i:06d}.npz"),
                 points=pts.astype(np.float32),
                 intensity=(intensity * 100.0).astype(np.float32),
                 transform=T_wv.astype(np.float32),
                 track_position=T_wv[:3, 3].astype(np.float32),
                 pose_quat=rotmat_to_quat(T_wv[:3, :3]), **extra)

    if calib_path and img_shape is not None:
        P = projection_matrix(read_calib(calib_path))
        np.savez(os.path.join(out_dir, "camera.npz"),
                 projection=P.reshape(-1),
                 image_height=np.int32(img_shape[0]),
                 image_width=np.int32(img_shape[1]))
    return len(bins)
