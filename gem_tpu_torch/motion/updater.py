"""Robot-motion process noise: pose covariance -> map variance update.

Counterpart of gem_tpu/motion/updater.py (RobotMotionMapUpdater): the 6x6
pose covariance is reduced to (x, y, z, yaw), differenced against the
previous frame in the z-aligned robot frame, and its position block pushed
through the translation Jacobian; the z-diagonal becomes one scalar
variance added to every fused cell.
"""

from __future__ import annotations

import dataclasses

import torch

from gem_tpu_torch.utils.device import constant


@dataclasses.dataclass(frozen=True)
class MotionState:
    prev_position: torch.Tensor      # (3,)
    prev_quat: torch.Tensor          # (4,) wxyz
    prev_reduced_cov: torch.Tensor   # (4, 4)


def init_motion_state(device) -> MotionState:
    f32 = dict(dtype=torch.float32, device=device)
    return MotionState(prev_position=torch.zeros(3, **f32),
                       prev_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32),
                       prev_reduced_cov=torch.zeros((4, 4), **f32))


def quat_to_rotmat(q):
    """wxyz quaternion -> rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def _zyx_yaw_pitch(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    pitch = torch.asin(torch.clamp(2 * (w * y - x * z), -1.0, 1.0))
    return yaw, pitch


def _rotvec_z(q):
    """z component of the axis-angle rotation vector."""
    w = torch.clamp(q[0], -1.0, 1.0)
    angle = 2.0 * torch.acos(w)
    s = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-12))
    return torch.where(angle < 1e-6, 0.0, angle * (q[3] / s))


def reduced_covariance(quat, pose_cov):
    """(A.3-A.5): project the 6x6 pose covariance onto (x, y, z, yaw)."""
    yaw, pitch = _zyx_yaw_pitch(quat)
    tp = torch.tan(pitch)
    jac = torch.zeros((4, 6), dtype=torch.float32, device=quat.device)
    jac[:3, :3] = torch.eye(3, device=quat.device)
    jac[3, 3:] = torch.stack([torch.cos(yaw) * tp, torch.sin(yaw) * tp,
                              torch.ones_like(tp)])
    return jac @ pose_cov.to(torch.float32) @ jac.T


def relative_covariance(position, quat, reduced, prev: MotionState):
    """(A.8-A.14): covariance of the pose increment in the z-aligned
    frame."""
    dev = quat.device
    rz = _rotvec_z(quat)
    c, s = torch.cos(rz), torch.sin(rz)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R_tilde = torch.stack([torch.stack([c, -s, zero]),
                           torch.stack([s, c, zero]),
                           torch.stack([zero, zero, one])])
    R_prev = quat_to_rotmat(prev.prev_quat)
    v_dt = R_prev.T @ (position.to(torch.float32) - prev.prev_position)

    ez_skew = constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0),
                        (0.0, 0.0, 0.0)), str(dev))
    F = torch.eye(4, dtype=torch.float32, device=dev)
    F[:3, 3] = ez_skew @ R_tilde @ v_dt
    # eye, not zeros and a scalar store: a Python scalar written into a CUDA
    # tensor is an upload from the host, which no CUDA graph can hold
    invG = torch.eye(4, dtype=torch.float32, device=dev)
    invGT = invG.clone()
    invG[:3, :3] = R_tilde.T
    invGT[:3, :3] = R_tilde
    return invG @ (reduced - F @ prev.prev_reduced_cov @ F.T) @ invGT


def process_noise(position, quat, pose_cov, motion: MotionState,
                  covariance_scale: float = 1.0):
    """Scalar z-variance update + new MotionState (J_r = -R_robot)."""
    cov = pose_cov.to(torch.float32) * covariance_scale
    reduced = reduced_covariance(quat, cov)
    rel = relative_covariance(position, quat, reduced, motion)
    J_r = -quat_to_rotmat(quat)
    var_update = (J_r @ rel[:3, :3] @ J_r.T)[2, 2]
    new_motion = MotionState(prev_position=position.to(torch.float32),
                             prev_quat=quat.to(torch.float32),
                             prev_reduced_cov=reduced)
    return var_update, new_motion


def apply_process_noise(variance, var_update, invalid_variance: float = -10.0):
    """G_Mapvar_update: add to every fused cell."""
    return torch.where(variance != invalid_variance, variance + var_update,
                       variance)
