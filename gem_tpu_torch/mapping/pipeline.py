"""The per-frame mapping step: move -> point process -> streaming fuse ->
motion process noise -> plane-fit features -> submap shed -> raytrace
cleanup -> keyframe finalize.

Counterpart of gem_tpu/mapping/pipeline.py `step`.  `fuse_backend`:

  * "stream" (the default, the configuration the JAX package ships on an
    accelerator): kernels/fuse_stream.py, whose aggregate pass is kernel
    K1 and which also owns the `lowest` reduction;
  * "segment", "sort", "pallas": point processing computes `lowest`, then
    kernels/fuse.py fuses; "pallas" reduces through kernel K3.

The features are always kernel K2's wrapper, `plane_fit_features`.  As
the JAX package picks its feature backend from the platform, each kernel
wrapper picks by device: its plain PyTorch version on CPU tensors, the CUDA
kernel on CUDA tensors.  There is no calibration-driven "auto": the fuse
backend is named.

Known sync cost: JAX branches on device scalars with `lax.cond` (jump vs
move, the raytrace cadence, keyframe finalize, the staging flush).  Here the
four predicates are read to the host ONCE per frame, in one `.tolist()`,
and the taken branch runs in Python.  Everything else stays on the device;
the storage<->geographic rolls are gathers by device indices, so `start` is
never read.  Capturing the step in a CUDA graph with masked selects is
later work (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from gem_tpu_torch.core.move import ShedCells, empty_shed, move, re_anchor
from gem_tpu_torch.core.state import MapState, init_map_state
from gem_tpu_torch.global_map import submaps as sm
from gem_tpu_torch.kernels.features import FeatureMaps, plane_fit_features
from gem_tpu_torch.kernels.fuse import fuse
from gem_tpu_torch.kernels.fuse_stream import fuse_stream
from gem_tpu_torch.kernels.pointproc import process_points
from gem_tpu_torch.kernels.raytrace import raytrace_cleanup
from gem_tpu_torch.motion.updater import (MotionState, apply_process_noise,
                                          init_motion_state, process_noise)
from gem_tpu_torch.render.products import orthomosaic
from gem_tpu_torch.sensors.models import jacobian_ingredients
from gem_tpu_torch.utils.device import resolve_device
from gem_tpu_torch.utils.tree import tree_map

FUSE_BACKENDS = ("stream", "segment", "sort", "pallas")


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
    the front: (points (M, 3), count)."""
    P = frame.points.shape[0]
    dev = frame.points.device
    if M < P:
        idx = torch.round(torch.linspace(0, P - 1, M, device=dev)).long()
    else:
        idx = torch.arange(M, device=dev) % P
    sel_ok = frame.valid[idx] & (torch.arange(M, device=dev) < P)
    pos = torch.cumsum(sel_ok.to(torch.int32), 0) - 1
    tgt = torch.where(sel_ok, pos, M).long()        # row M: dump, cut off
    pts = torch.zeros((M + 1, 3), dtype=torch.float32, device=dev)
    pts.index_copy_(0, tgt, frame.points[idx].to(torch.float32))
    return pts[:M], sel_ok.sum(dtype=torch.int32)


def _check_backend(fuse_backend: str) -> None:
    if fuse_backend not in FUSE_BACKENDS:
        raise ValueError(f"fuse_backend {fuse_backend!r} is not one of "
                         f"{FUSE_BACKENDS}")


def step(state: PipelineState, frame: Frame, cfg,
         fuse_backend: str = "stream") -> tuple[PipelineState, StepOutputs]:
    """One frame.  `state` is consumed (the submap rings update in place,
    see global_map/submaps.py); use the returned state."""
    _check_backend(fuse_backend)
    track = frame.track_position.to(torch.float32)
    dev = track.device

    # --- odometry-jump bookkeeping (src/ElevationMapping.cpp:987-993) ------
    jump_odom = state.jump_odom
    if frame.loop_closure is not None:
        jump_odom = jump_odom | frame.loop_closure.to(torch.bool)
    dz = torch.abs(track[2] - state.last_track_z)
    settled = jump_odom & (dz <= cfg.jump_z_tolerance)
    jump_count = torch.where(settled, state.jump_count + 1, state.jump_count)
    finish = ~settled & (jump_count >= cfg.jump_settle_count)
    jump_count = torch.where(finish, 0, jump_count)
    jump_odom = jump_odom & ~finish
    use_jump = jump_odom

    # --- the frame's host sync: every branch predicate in one read --------
    if cfg.enable_submaps:
        dist = torch.linalg.vector_norm(track[:2] - state.last_keyframe_xy)
        keyframe_due = dist >= cfg.submap.keyframe_distance
    else:
        keyframe_due = torch.zeros((), dtype=torch.bool, device=dev)
    raytrace_due = torch.remainder(state.frame_idx,
                                   max(cfg.raytrace_every, 1)) == 0
    jump_h, keyframe_h, raytrace_h, staged_h = torch.stack([
        use_jump.to(torch.int32), keyframe_due.to(torch.int32),
        raytrace_due.to(torch.int32),
        state.submaps.staging_used.to(torch.int32)]).tolist()

    # --- window relocation ------------------------------------------------
    if jump_h:
        map_state = re_anchor(state.map, cfg.map, track,
                              track[2] - state.last_track_z)
        map_state = map_state.replace(sensor_z=track[2].clone())
        shed = empty_shed(cfg, dev)
        index_shift = torch.zeros((2,), dtype=torch.int32, device=dev)
    else:
        map_state, info = move(state.map, cfg.map, track)
        shed, index_shift = info.shed, info.index_shift

    # --- point processing ---------------------------------------------------
    sensor_jac, c_sb_t, p_bm_t, b_skew = jacobian_ingredients(
        frame.r_map_base, frame.r_base_sensor, frame.t_base_sensor)
    stream = fuse_backend == "stream"
    batch, lowest = process_points(
        map_state, cfg, frame.points, frame.intensity, frame.valid,
        frame.transform, frame.t_map_base[2].to(torch.float32), sensor_jac,
        frame.pose_cov[3:, 3:].to(torch.float32), c_sb_t, p_bm_t, b_skew,
        image=frame.image, colors=frame.colors, compute_lowest=not stream)
    map_state = map_state.replace(lowest=lowest)

    # --- fuse (K1 on the stream path, K3 on the pallas path) ----------------
    if stream:
        map_state = fuse_stream(map_state, cfg, batch,
                                with_lowest=cfg.enable_lowest,
                                with_color=cfg.enable_color)
    else:
        map_state = fuse(map_state, cfg, batch, backend=fuse_backend)

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
        feats = FeatureMaps(slope=torch.zeros((L, L), **f32),
                            rough=torch.zeros((L, L), **f32),
                            traver=map_state.traver,
                            normal_z=torch.ones((L, L), **f32),
                            neighbor_count=torch.zeros(
                                (L, L), dtype=torch.int32, device=dev))

    # --- submap shed accumulation ------------------------------------------
    # no shed during the jump nor on the frame it settles (JumpFlag,
    # src/ElevationMapping.cpp:630, 716, 766)
    suppress = use_jump | finish
    shed = dataclasses.replace(shed, valid=shed.valid & ~suppress)
    submaps = state.submaps
    if cfg.enable_submaps:
        submaps = sm.append_shed(submaps, shed, staged=staged_h)

    # --- raytrace visibility cleanup ---------------------------------------
    if cfg.enable_raytrace and raytrace_h:
        map_state = raytrace_cleanup(map_state, cfg.map, feats.traver)

    # --- keyframe finalize (src/ElevationMapping.cpp:624-627) ---------------
    last_keyframe_xy = state.last_keyframe_xy
    if cfg.enable_submaps and keyframe_h:
        grid_pts = sm.grid_to_points(map_state, cfg, feats.traver)
        pose = torch.cat([track, frame.pose_quat.to(torch.float32)])
        # SubMap payload (src/ElevationMapping.cpp:666-681): orthomosaic
        # snapshot + subsampled raw keyframe scan
        ortho = kf_pts = kf_count = None
        if cfg.submap.store_ortho:
            ortho = orthomosaic(map_state, cfg.map, feats.traver)
        if cfg.submap.keyframe_scan_points > 0:
            kf_pts, kf_count = _keyframe_scan(
                frame, cfg.submap.keyframe_scan_points)
        submaps = sm.finalize_submap(submaps, grid_pts, pose, ortho=ortho,
                                     kf_points=kf_pts, kf_count=kf_count)
        last_keyframe_xy = track[:2].clone()

    new_state = PipelineState(
        map=map_state, motion=motion, submaps=submaps,
        jump_odom=jump_odom, jump_count=jump_count,
        last_track_z=track[2].clone(), last_keyframe_xy=last_keyframe_xy,
        frame_idx=state.frame_idx + 1)
    metrics = {
        "points_valid": batch.valid.sum(dtype=torch.int32),
        "cells_fused": (map_state.elevation
                        != cfg.map.invalid_elevation).sum(dtype=torch.int32),
        "shed_count": shed.valid.sum(dtype=torch.int32),
        "index_shift": index_shift,
        "var_update": var_update,
    }
    return new_state, StepOutputs(features=feats, shed=shed,
                                  keyframe_due=keyframe_due, metrics=metrics)


def scan_steps(state: PipelineState, frames: Iterable[Frame], cfg,
               fuse_backend: str = "stream"):
    """Run a frame sequence; returns (final_state, dict of (T,) per-frame
    metric tensors: points_valid, cells_fused, shed_count, keyframe)."""
    rows = []
    for frame in frames:
        state, out = step(state, frame, cfg, fuse_backend)
        rows.append((out.metrics["points_valid"], out.metrics["cells_fused"],
                     out.metrics["shed_count"], out.keyframe_due))
    names = ("points_valid", "cells_fused", "shed_count", "keyframe")
    return state, {k: torch.stack([r[i] for r in rows])
                   for i, k in enumerate(names)}


class ElevationPipeline:
    """Frames in, state + features out, on one device (the card unless
    `device="cpu"`)."""

    def __init__(self, cfg, device="cuda", fuse_backend: str = "stream"):
        from gem_tpu_torch.config import validate_config

        validate_config(cfg)
        _check_backend(fuse_backend)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fuse_backend = fuse_backend
        self.state = init_pipeline_state(cfg, self.device)
        self.last_outputs: Optional[StepOutputs] = None

    def process(self, frame: Frame) -> StepOutputs:
        self.state, out = step(self.state, frame, self.cfg,
                               self.fuse_backend)
        self.last_outputs = out
        return out


# ---------------------------------------------------------------------------
# State exchange with NumPy trees (e.g. `jax.tree.map(np.asarray, state)`)

_NESTED = {
    PipelineState: {"map": MapState, "motion": MotionState,
                    "submaps": sm.SubmapStore},
    sm.SubmapStore: {"slots": sm.PointBuffer, "accum": sm.PointBuffer,
                     "staging": sm.PointBuffer},
}


def _from_tree(cls, tree, device):
    nested = _NESTED.get(cls, {})
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(tree, f.name)
        if f.name in nested:
            kw[f.name] = _from_tree(nested[f.name], v, device)
        else:
            kw[f.name] = torch.from_numpy(np.array(v)).to(device)
    return cls(**kw)


def state_from_numpy(tree, device) -> PipelineState:
    """Port PipelineState from any tree with the same field names and NumPy
    leaves (a JAX PipelineState mapped through np.asarray, or the result of
    `state_to_numpy`), the orthomosaic ring included."""
    return _from_tree(PipelineState, tree, device)


def state_to_numpy(state: PipelineState) -> PipelineState:
    """The same dataclasses with NumPy leaves (inverse of
    `state_from_numpy`)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)


def frame_from_numpy(frame, device) -> Frame:
    """Port Frame from a frame with NumPy/array leaves (e.g. a gem_tpu
    Frame); a None `image` stays None."""
    kw = {}
    for f in dataclasses.fields(Frame):
        v = getattr(frame, f.name)
        kw[f.name] = None if v is None else \
            torch.from_numpy(np.array(v)).to(device)
    return Frame(**kw)
