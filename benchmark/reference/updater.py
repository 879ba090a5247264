"""Robot-motion process noise: pose covariance -> map variance update.

Counterpart of gem_tpu/motion/updater.py (RobotMotionMapUpdater): the 6x6
pose covariance is reduced to (x, y, z, yaw), differenced against the
previous frame in the z-aligned robot frame, and its position block pushed
through the translation Jacobian; the z-diagonal becomes one scalar
variance added to every fused cell.

Every input may carry a leading robot axis (positions (R, 3), quaternions
(R, 4), covariances (R, 6, 6)).  The 3x3 / 4x4 / 6x6 products are
products and one sum over the shared dims (`_mm`, `_mm3`), so a robot's
result does not depend on how many robots share the call (a batched `@`
may take another summation order than an unbatched one).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.device import constant
from benchmark.reference.precision import operand
from benchmark.reference.tree import lead


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


def _rotmat(q):
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices."""
    return quat_to_rotmat(q.movedim(-1, 0)).movedim((0, 1), (-2, -1))


def _t(m):
    return m.transpose(-1, -2)


def _mm(a, b):
    """a (..., n, k) @ b (..., k, m) as one product and one sum over k.
    Each entry's k terms are reduced by one thread in an order fixed by k
    alone (on the CPU and the card), so an entry does not depend on how
    many robots share the call, as a batched matmul's may."""
    a, b = operand(a), operand(b)
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mm3(a, b, c):
    """a (..., n, k) @ b (..., k, l) @ c (..., l, m) as the k * l products
    of each entry and one sum over them, as `_mm` does for one product."""
    a, b, c = operand(a), operand(b), operand(c)
    return (a[..., :, :, None, None] * b[..., None, :, :, None]
            * c[..., None, None, :, :]).sum((-3, -2))


def _eye(n, lead, device):
    return torch.eye(n, dtype=torch.float32, device=device).expand(
        lead + (n, n)).clone()


def _zyx_yaw_pitch(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    pitch = torch.asin(torch.clamp(2 * (w * y - x * z), -1.0, 1.0))
    return yaw, pitch


def _rotvec_z(q):
    """z component of the axis-angle rotation vector."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.acos(w)
    s = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-12))
    return torch.where(angle < 1e-6, 0.0, angle * (q[..., 3] / s))


def reduced_covariance(quat, pose_cov):
    """(A.3-A.5): project the 6x6 pose covariance onto (x, y, z, yaw)."""
    yaw, pitch = _zyx_yaw_pitch(quat)
    tp = torch.tan(pitch)
    jac = torch.zeros(quat.shape[:-1] + (4, 6), dtype=torch.float32,
                      device=quat.device)
    jac[..., :3, :3] = torch.eye(3, device=quat.device)
    jac[..., 3, 3:] = torch.stack([torch.cos(yaw) * tp, torch.sin(yaw) * tp,
                                   torch.ones_like(tp)], dim=-1)
    return _mm3(jac, pose_cov.to(torch.float32), _t(jac))


def relative_covariance(position, quat, reduced, prev: MotionState):
    """(A.8-A.14): covariance of the pose increment in the z-aligned
    frame."""
    dev = quat.device
    lead = quat.shape[:-1]
    rz = _rotvec_z(quat)
    c, s = torch.cos(rz), torch.sin(rz)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R_tilde = torch.stack([torch.stack([c, -s, zero], dim=-1),
                           torch.stack([s, c, zero], dim=-1),
                           torch.stack([zero, zero, one], dim=-1)], dim=-2)
    R_prev = _rotmat(prev.prev_quat)
    d = (position.to(torch.float32) - prev.prev_position)[..., :, None]
    v_dt = _mm(_t(R_prev), d)                                 # (..., 3, 1)

    ez_skew = constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0),
                        (0.0, 0.0, 0.0)), str(dev))
    F = _eye(4, lead, dev)
    F[..., :3, 3] = _mm3(ez_skew, R_tilde, v_dt)[..., 0]
    # eye, not zeros and a scalar store: a Python scalar written into a CUDA
    # tensor is an upload from the host, which no CUDA graph can hold
    invG = _eye(4, lead, dev)
    invGT = invG.clone()
    invG[..., :3, :3] = _t(R_tilde)
    invGT[..., :3, :3] = R_tilde
    inner = reduced - _mm3(F, prev.prev_reduced_cov, _t(F))
    return _mm3(invG, inner, invGT)


def process_noise(position, quat, pose_cov, motion: MotionState,
                  covariance_scale: float = 1.0):
    """Scalar z-variance update + new MotionState (J_r = -R_robot)."""
    cov = pose_cov.to(torch.float32) * covariance_scale
    reduced = reduced_covariance(quat, cov)
    rel = relative_covariance(position, quat, reduced, motion)
    # (J_r rel J_r^T)[2, 2], from row 2 of J_r alone
    j2 = -_rotmat(quat)[..., 2:3, :]
    var_update = _mm3(j2, rel[..., :3, :3], _t(j2))[..., 0, 0]
    new_motion = MotionState(prev_position=position.to(torch.float32),
                             prev_quat=quat.to(torch.float32),
                             prev_reduced_cov=reduced)
    return var_update, new_motion


def apply_process_noise(variance, var_update, invalid_variance: float = -10.0):
    """G_Mapvar_update: add to every fused cell (`var_update` is () or one
    per robot of an (R, L, L) stack)."""
    if isinstance(var_update, torch.Tensor):
        var_update = lead(var_update, variance)
    return torch.where(variance != invalid_variance, variance + var_update,
                       variance)
