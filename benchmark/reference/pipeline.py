"""A frozen copy of the port's per-frame mapping step on its plain path:
move -> point process -> streaming fuse -> motion process noise ->
plane-fit features -> submap shed -> raytrace cleanup -> keyframe finalize.

The benchmark's reference.  It runs the plain PyTorch versions of the
fuse aggregate and the plane fit on whatever device its tensors are on,
and takes each branch of the step on the host (`control.py`), so one
robot (R = 1) runs only the taken side.  It imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.reference.move import ShedCells, empty_shed, move, re_anchor
from benchmark.reference.state import MapState, init_map_state
from benchmark.reference import submaps as sm
from benchmark.reference.features import FeatureMaps, plane_fit_features
from benchmark.reference.fuse_stream import fuse_stream
from benchmark.reference.pointproc import process_points
from benchmark.reference.raytrace import raytrace_cleanup
from benchmark.reference.updater import (MotionState, apply_process_noise,
                                          init_motion_state, process_noise)
from benchmark.reference.products import orthomosaic
from benchmark.reference.models import jacobian_ingredients
from benchmark.reference import control
from benchmark.reference.tree import tree_map

FUSE_BACKENDS = ("stream",)


@dataclasses.dataclass(frozen=True)
class Frame:
    """One sensor frame (fixed shapes; P = cfg.max_points)."""

    points: torch.Tensor          # (P, 3) sensor-frame xyz
    intensity: torch.Tensor       # (P,)
    valid: torch.Tensor           # (P,) bool, False for padding
    transform: torch.Tensor       # (4, 4) sensor -> map
    r_base_sensor: torch.Tensor   # (3, 3)
    t_base_sensor: torch.Tensor   # (3,)
    r_map_base: torch.Tensor      # (3, 3)
    t_map_base: torch.Tensor      # (3,)
    track_position: torch.Tensor  # (3,) robot track point in map frame
    pose_quat: torch.Tensor       # (4,) wxyz robot orientation
    pose_cov: torch.Tensor        # (6, 6)
    colors: torch.Tensor          # (P,) int32 packed rgb (0 if none)
    image: Optional[torch.Tensor] = None   # (H, W, 3) uint8
    loop_closure: Optional[torch.Tensor] = None   # () bool; None = False


@dataclasses.dataclass(frozen=True)
class PipelineState:
    map: MapState
    motion: MotionState
    submaps: sm.SubmapStore
    jump_odom: torch.Tensor        # () bool: loop-closure jump unsettled
    jump_count: torch.Tensor       # () int32 consecutive settled frames
    last_track_z: torch.Tensor     # () f32
    last_keyframe_xy: torch.Tensor  # (2,)
    frame_idx: torch.Tensor        # () int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class StepOutputs:
    features: FeatureMaps
    shed: ShedCells
    keyframe_due: torch.Tensor     # () bool
    metrics: dict


def init_pipeline_state(cfg, device) -> PipelineState:
    dev = torch.device(device)
    return PipelineState(
        map=init_map_state(cfg.map, dev),
        motion=init_motion_state(dev),
        submaps=sm.init_store(cfg, dev),
        jump_odom=torch.zeros((), dtype=torch.bool, device=dev),
        jump_count=torch.zeros((), dtype=torch.int32, device=dev),
        last_track_z=torch.zeros((), dtype=torch.float32, device=dev),
        last_keyframe_xy=torch.zeros((2,), dtype=torch.float32, device=dev),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _keyframe_scan(frame: Frame, M: int):
    """Subsampled raw scan of the keyframe frame, valid rows compacted to
    the front: (points (..., M, 3), count (...))."""
    P = frame.points.shape[-2]
    lead = frame.points.shape[:-2]
    dev = frame.points.device
    if M < P:
        idx = torch.round(torch.linspace(0, P - 1, M, device=dev)).long()
    else:
        idx = torch.arange(M, device=dev) % P
    sel_ok = frame.valid[..., idx] & (torch.arange(M, device=dev) < P)
    pos = torch.cumsum(sel_ok.to(torch.int32), -1) - 1
    tgt = torch.where(sel_ok, pos, M).long()        # row M: dump, cut off
    pts = torch.zeros(lead + (M + 1, 3), dtype=torch.float32, device=dev)
    pts.scatter_(-2, tgt[..., None].expand(lead + (M, 3)),
                 frame.points[..., idx, :].to(torch.float32))
    return pts[..., :M, :], sel_ok.sum(-1, dtype=torch.int32)


def _unchanged(x):
    return x


def _check_backend(fuse_backend: str) -> None:
    if fuse_backend not in FUSE_BACKENDS:
        raise ValueError(f"fuse_backend {fuse_backend!r} is not one of "
                         f"{FUSE_BACKENDS}")


def step(state: PipelineState, frame: Frame, cfg,
         fuse_backend: str = "stream") -> tuple[PipelineState, StepOutputs]:
    """One frame.  `state` is consumed (the submap rings update in place,
    see global_map/submaps.py); use the returned state.  This is
    `batched_step` for one robot: the leaves are viewed with a robot axis
    of 1 and the results viewed without it."""
    one = lambda x: x.unsqueeze(0)
    new, out = batched_step(tree_map(one, state), tree_map(one, frame), cfg,
                            fuse_backend)
    first = lambda x: x[0]
    return tree_map(first, new), tree_map(first, out)


def batched_step(state: PipelineState, frame: Frame, cfg,
                 fuse_backend: str = "stream"
                 ) -> tuple[PipelineState, StepOutputs]:
    """One frame for every robot: `state` and `frame` carry a leading robot
    axis R on every leaf, and so do the results.  `state` is consumed."""
    _check_backend(fuse_backend)
    track = frame.track_position.to(torch.float32)
    dev = track.device
    R = track.shape[0]

    # --- odometry-jump bookkeeping (src/ElevationMapping.cpp:987-993) ------
    jump_odom = state.jump_odom
    if frame.loop_closure is not None:
        jump_odom = jump_odom | frame.loop_closure.to(torch.bool)
    dz = torch.abs(track[:, 2] - state.last_track_z)
    settled = jump_odom & (dz <= cfg.jump_z_tolerance)
    jump_count = torch.where(settled, state.jump_count + 1, state.jump_count)
    finish = ~settled & (jump_count >= cfg.jump_settle_count)
    jump_count = torch.where(finish, 0, jump_count)
    jump_odom = jump_odom & ~finish
    use_jump = jump_odom

    # --- window relocation: lax.cond (utils/control.py) -----------------
    def _jump_branch(ms):
        anchored = re_anchor(ms, cfg.map, track,
                             track[:, 2] - state.last_track_z)
        return (anchored.replace(sensor_z=track[:, 2].clone()),
                empty_shed(cfg, dev, (R,)),
                torch.zeros((R, 2), dtype=torch.int32, device=dev))

    def _move_branch(ms):
        moved, info = move(ms, cfg.map, track)
        return moved, info.shed, info.index_shift

    # the common side first: the merge of a captured cond copies into the
    # first side's outputs only on frames that take the second
    map_state, shed, index_shift = control.cond(
        ~use_jump, _move_branch, _jump_branch, state.map)

    # --- point processing ---------------------------------------------------
    sensor_jac, c_sb_t, p_bm_t, b_skew = jacobian_ingredients(
        frame.r_map_base, frame.r_base_sensor, frame.t_base_sensor)
    stream = fuse_backend == "stream"
    batch, lowest = process_points(
        map_state, cfg, frame.points, frame.intensity, frame.valid,
        frame.transform, frame.t_map_base[:, 2].to(torch.float32),
        sensor_jac, frame.pose_cov[:, 3:, 3:].to(torch.float32), c_sb_t,
        p_bm_t, b_skew, image=frame.image, colors=frame.colors,
        compute_lowest=not stream)
    map_state = map_state.replace(lowest=lowest)

    # --- fuse (K1 on the stream path, K3 on the pallas path) ----------------
    map_state = fuse_stream(map_state, cfg, batch,
                            with_lowest=cfg.enable_lowest,
                            with_color=cfg.enable_color)

    # --- motion process noise -----------------------------------------------
    var_update, motion = process_noise(track, frame.pose_quat, frame.pose_cov,
                                       state.motion,
                                       cfg.motion.covariance_scale)
    if not cfg.motion.ignore_robot_motion_updates:
        map_state = map_state.replace(
            variance=apply_process_noise(map_state.variance, var_update,
                                         cfg.map.invalid_variance))

    # --- features (K2) --------------------------------------------------------
    if cfg.enable_features:
        feats = plane_fit_features(map_state, cfg.map)
        map_state = map_state.replace(traver=feats.traver)
    else:
        L = cfg.map.length
        f32 = dict(dtype=torch.float32, device=dev)
        feats = FeatureMaps(slope=torch.zeros((R, L, L), **f32),
                            rough=torch.zeros((R, L, L), **f32),
                            traver=map_state.traver,
                            normal_z=torch.ones((R, L, L), **f32),
                            neighbor_count=torch.zeros(
                                (R, L, L), dtype=torch.int32, device=dev))

    # --- submap shed accumulation ------------------------------------------
    # no shed during the jump nor on the frame it settles (JumpFlag,
    # src/ElevationMapping.cpp:630, 716, 766)
    suppress = use_jump | finish
    shed = dataclasses.replace(shed, valid=shed.valid & ~suppress[:, None])
    submaps = state.submaps
    if cfg.enable_submaps:
        submaps = sm.append_shed(submaps, shed)

    # --- raytrace visibility cleanup ---------------------------------------
    if cfg.enable_raytrace:
        def _raytrace(ms):
            return raytrace_cleanup(ms, cfg.map, feats.traver)

        if cfg.raytrace_every > 1:
            due = torch.remainder(state.frame_idx, cfg.raytrace_every) == 0
            map_state = control.cond(due, _raytrace, _unchanged, map_state)
        else:
            map_state = _raytrace(map_state)

    # --- keyframe finalize (src/ElevationMapping.cpp:624-627) ---------------
    last_keyframe_xy = state.last_keyframe_xy
    if cfg.enable_submaps:
        dist = torch.linalg.vector_norm(track[:, :2] - state.last_keyframe_xy,
                                        dim=-1)
        keyframe_due = dist >= cfg.submap.keyframe_distance

        def _finalize(submaps, last_xy, when=None):
            """The keyframe branch, in place (`when` None) or masked."""
            grid_pts = sm.grid_to_points(map_state, cfg, feats.traver)
            pose = torch.cat([track, frame.pose_quat.to(torch.float32)],
                             dim=-1)
            # SubMap payload (src/ElevationMapping.cpp:666-681):
            # orthomosaic snapshot + subsampled raw keyframe scan
            ortho = kf_pts = kf_count = None
            if cfg.submap.store_ortho:
                ortho = orthomosaic(map_state, cfg.map, feats.traver)
            if cfg.submap.keyframe_scan_points > 0:
                kf_pts, kf_count = _keyframe_scan(
                    frame, cfg.submap.keyframe_scan_points)
            submaps = sm.finalize_submap(submaps, grid_pts, pose,
                                         ortho=ortho, kf_points=kf_pts,
                                         kf_count=kf_count, when=when)
            if when is None:
                return submaps, last_xy.copy_(track[:, :2])
            return submaps, torch.where(when[:, None], track[:, :2], last_xy)

        submaps, last_keyframe_xy = control.when(
            keyframe_due, _finalize, submaps, last_keyframe_xy)
    else:
        keyframe_due = torch.zeros((R,), dtype=torch.bool, device=dev)

    new_state = PipelineState(
        map=map_state, motion=motion, submaps=submaps,
        jump_odom=jump_odom, jump_count=jump_count,
        last_track_z=track[:, 2].clone(), last_keyframe_xy=last_keyframe_xy,
        frame_idx=state.frame_idx + 1)
    metrics = {
        "points_valid": batch.valid.sum(-1, dtype=torch.int32),
        "cells_fused": (map_state.elevation != cfg.map.invalid_elevation
                        ).sum((-2, -1), dtype=torch.int32),
        "shed_count": shed.valid.sum(-1, dtype=torch.int32),
        "index_shift": index_shift,
        "var_update": var_update,
    }
    return new_state, StepOutputs(features=feats, shed=shed,
                                  keyframe_due=keyframe_due, metrics=metrics)
