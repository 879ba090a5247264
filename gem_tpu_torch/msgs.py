# A copy of gem_tpu/msgs.py (the port reads nothing under gem_tpu/).
"""Typed record contracts: the dislam_msgs / slam_msg equivalents.

The reference exchanges ROS messages with the external MR_SLAM backend
(dislam_msgs/msg/*.msg, consumed slam_msg/Keyframes —
ElevationMapping.hpp:77-78).  TPU-native transport is arrays: each record is
a plain dataclass of numpy arrays with npz (de)serialisation, so submap
publication becomes a host offload and loop-closure input a file/array drop.

  SubMapRecord    <- dislam_msgs/SubMap (submap cloud + keyframe cloud +
                     ortho image + pose)
  KeyframesRecord <- slam_msg/Keyframes (optimised keyframe poses; triggers
                     the loop-closure re-stitch)
  DiSCORecord     <- dislam_msgs/DiSCO (place-recognition signature + fft)
  InterPRRecord   <- dislam_msgs/InterPR(s) (inter-robot place-recognition
                     exchange)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def _opt(d, key):
    return d[key] if key in d.files else None


@dataclasses.dataclass
class SubMapRecord:
    """One published submap (dislam_msgs/SubMap.msg)."""

    points: np.ndarray            # (N, 3) f32 world frame
    colors: np.ndarray            # (N,) i32 packed rgb
    variance: np.ndarray          # (N,) f32
    intensity: np.ndarray         # (N,) f32
    traver: np.ndarray            # (N,) f32
    pose: np.ndarray              # (7,) [xyz, quat wxyz]
    ortho_image: Optional[np.ndarray] = None   # (L, L, 3) u8
    keyframe_points: Optional[np.ndarray] = None  # (M, 3) raw keyframe scan
    robot_id: int = 0
    stamp: float = 0.0

    def save(self, path: str):
        extra = {}
        if self.ortho_image is not None:
            extra["ortho_image"] = self.ortho_image
        if self.keyframe_points is not None:
            extra["keyframe_points"] = self.keyframe_points
        np.savez_compressed(path, points=self.points, colors=self.colors,
                            variance=self.variance, intensity=self.intensity,
                            traver=self.traver, pose=self.pose,
                            robot_id=np.int32(self.robot_id),
                            stamp=np.float64(self.stamp), **extra)

    @classmethod
    def load(cls, path: str) -> "SubMapRecord":
        d = np.load(path)
        return cls(points=d["points"], colors=d["colors"],
                   variance=d["variance"], intensity=d["intensity"],
                   traver=d["traver"], pose=d["pose"],
                   ortho_image=_opt(d, "ortho_image"),
                   keyframe_points=_opt(d, "keyframe_points"),
                   robot_id=int(d["robot_id"]), stamp=float(d["stamp"]))


def submap_record_from_store(store, index: int, ortho=None,
                             keyframe_points=None, robot_id: int = 0,
                             stamp: float = 0.0) -> SubMapRecord:
    """Extract slot `index` of a SubmapStore as a compacted SubMapRecord
    (the subMapPublisher_ payload, src/ElevationMapping.cpp:664-681).

    The orthoImage / keyframePC payload defaults to the store's per-keyframe
    snapshot rings (captured at finalize time by the pipeline); explicit
    `ortho` / `keyframe_points` arguments override."""
    valid = np.asarray(store.slots.valid[index])
    pick = lambda a: np.asarray(a[index])[valid]
    pts = np.stack([pick(store.slots.x), pick(store.slots.y),
                    pick(store.slots.z)], axis=-1)
    if ortho is None and store.orthos.shape[1] > 0:
        ortho = store.orthos[index]
    if keyframe_points is None and store.kf_points.shape[1] > 0:
        n = int(store.kf_counts[index])
        keyframe_points = np.asarray(store.kf_points[index])[:n] \
            if n > 0 else None
    return SubMapRecord(
        points=pts, colors=pick(store.slots.color),
        variance=pick(store.slots.variance),
        intensity=pick(store.slots.intensity),
        traver=pick(store.slots.traver),
        pose=np.asarray(store.poses[index]),
        ortho_image=None if ortho is None else np.asarray(ortho),
        keyframe_points=keyframe_points, robot_id=robot_id, stamp=stamp)


@dataclasses.dataclass
class KeyframesRecord:
    """Optimised keyframe poses after SLAM optimisation (slam_msg/Keyframes,
    consumed by optKeyframeCallback src/ElevationMapping.cpp:577-593)."""

    ids: np.ndarray     # (K,) i32
    poses: np.ndarray   # (K, 7) [xyz, quat wxyz]
    stamp: float = 0.0

    def save(self, path: str):
        np.savez_compressed(path, ids=self.ids, poses=self.poses,
                            stamp=np.float64(self.stamp))

    @classmethod
    def load(cls, path: str) -> "KeyframesRecord":
        d = np.load(path)
        return cls(ids=d["ids"], poses=d["poses"], stamp=float(d["stamp"]))


@dataclasses.dataclass
class DiSCORecord:
    """Place-recognition signature (dislam_msgs/DiSCO.msg)."""

    signature: np.ndarray      # (D,) f32
    fft_real: np.ndarray       # (F,) f32
    fft_imag: np.ndarray       # (F,) f32
    pose: np.ndarray           # (7,)
    stamp: float = 0.0

    def save(self, path: str):
        np.savez_compressed(path, signature=self.signature,
                            fft_real=self.fft_real, fft_imag=self.fft_imag,
                            pose=self.pose, stamp=np.float64(self.stamp))

    @classmethod
    def load(cls, path: str) -> "DiSCORecord":
        d = np.load(path)
        return cls(signature=d["signature"], fft_real=d["fft_real"],
                   fft_imag=d["fft_imag"], pose=d["pose"],
                   stamp=float(d["stamp"]))


@dataclasses.dataclass
class InterPRRecord:
    """Inter-robot place-recognition candidate (dislam_msgs/InterPR.msg)."""

    id0: int
    id1: int
    is_aerial: bool
    is_checked: bool
    id0_pose: np.ndarray      # (7,)
    factor_pose: np.ndarray   # (7,)
    keyframe_points: Optional[np.ndarray] = None


@dataclasses.dataclass
class InterPRsRecord:
    """Batch of InterPR exchanges (dislam_msgs/InterPRs.msg)."""

    seq: int
    items: List[InterPRRecord]

    def save(self, path: str):
        n = len(self.items)
        kp = {f"kp_{i}": it.keyframe_points for i, it in
              enumerate(self.items) if it.keyframe_points is not None}
        np.savez_compressed(
            path, seq=np.int32(self.seq),
            id0=np.asarray([it.id0 for it in self.items], np.int64),
            id1=np.asarray([it.id1 for it in self.items], np.int64),
            is_aerial=np.asarray([it.is_aerial for it in self.items], bool),
            is_checked=np.asarray([it.is_checked for it in self.items], bool),
            id0_pose=np.stack([it.id0_pose for it in self.items])
            if n else np.zeros((0, 7), np.float32),
            factor_pose=np.stack([it.factor_pose for it in self.items])
            if n else np.zeros((0, 7), np.float32),
            **kp)

    @classmethod
    def load(cls, path: str) -> "InterPRsRecord":
        d = np.load(path)
        items = []
        for i in range(len(d["id0"])):
            items.append(InterPRRecord(
                id0=int(d["id0"][i]), id1=int(d["id1"][i]),
                is_aerial=bool(d["is_aerial"][i]),
                is_checked=bool(d["is_checked"][i]),
                id0_pose=d["id0_pose"][i], factor_pose=d["factor_pose"][i],
                keyframe_points=_opt(d, f"kp_{i}")))
        return cls(seq=int(d["seq"]), items=items)
