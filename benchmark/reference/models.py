"""Sensor noise models as batched tensor functions.

Counterpart of gem_tpu/sensors/models.py: all four models (laser,
structured light, stereo, perfect) and the common error-propagation law

    sigma_p^2 = J_q Sigma_q J_q^T + J_s Sigma_s J_s^T

The small contractions are written out elementwise: every term is an exact
fp32 product/sum, so the CPU and CUDA results agree bit for bit and no
TF32 path can be taken.  Frame-dependent inputs may carry a leading robot
axis: points (..., N, 3) with their matrices (..., 3, 3) and vectors
(..., 3).
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import operand


def _laser(cfg, points, distance):
    """Pomerleau et al. beam model: sigma_n = min_radius,
    sigma_l = beam_constant + beam_angle * d (gpu_process.cu:410-411)."""
    var_normal = torch.full_like(distance, cfg.min_radius ** 2)
    var_lateral = (cfg.beam_constant + cfg.beam_angle * distance) ** 2
    return var_lateral, var_normal


def _structured_light(cfg, points, distance):
    """Nguyen et al. 2012 Kinect model; uses depth z, not range."""
    z = points[..., 2]
    dev_n = (cfg.normal_factor_a
             + cfg.normal_factor_b * (z - cfg.normal_factor_c) ** 2
             + cfg.normal_factor_d * torch.pow(torch.clamp(z, min=1e-6),
                                               cfg.normal_factor_e))
    dev_l = cfg.lateral_factor * z
    return dev_l ** 2, dev_n ** 2


def _stereo(cfg, points, distance, pixel_uv=None):
    """Disparity model (StereoSensorProcessor.cpp:85-92)."""
    z = torch.clamp(points[..., 2], min=1e-6)
    f = cfg.depth_to_disparity_factor
    disparity = f / z
    if pixel_uv is None:
        du = torch.zeros_like(z)
        dv = torch.zeros_like(z)
    else:
        du = cfg.p_3 * disparity + cfg.p_4 - pixel_uv[..., 0]
        dv = cfg.stereo_center_v - pixel_uv[..., 1]
    var_normal = (f / disparity ** 2) ** 2 * (
        (cfg.p_5 * disparity + cfg.p_2) * torch.sqrt(du ** 2 + dv ** 2)
        + cfg.p_1)
    var_lateral = (cfg.lateral_factor * distance) ** 2
    return var_lateral, var_normal


def _perfect(cfg, points, distance):
    zeros = torch.zeros_like(distance)
    return zeros, zeros


SENSOR_MODELS = {
    "laser": _laser,
    "structured_light": _structured_light,
    "stereo": _stereo,
    "perfect": _perfect,
}


def sensor_variances(cfg, points, pixel_uv=None):
    """(var_lateral, var_normal) per point; points are (N, 3) sensor-frame."""
    distance = torch.linalg.vector_norm(points, dim=-1)
    if cfg.model == "stereo":
        return _stereo(cfg, points, distance, pixel_uv=pixel_uv)
    return SENSOR_MODELS[cfg.model](cfg, points, distance)


def _vecmat(v, m):
    """Row vector (..., 3) times matrix (..., 3, 3), written out: v @ m."""
    v, m = operand(v), operand(m)
    return (v[..., 0, None] * m[..., 0, :] + v[..., 1, None] * m[..., 1, :]
            + v[..., 2, None] * m[..., 2, :])


def height_variance(cfg, points, sensor_jacobian, rotation_variance, c_sb_t,
                    p_mul_c_bm_t, b_r_bs_skew, pixel_uv=None):
    """Propagated per-point height variance sigma_p^2 for a (..., N, 3)
    batch (`cfg` is a SensorConfig)."""
    points = points.to(torch.float32)
    var_lat, var_norm = sensor_variances(cfg, points, pixel_uv=pixel_uv)

    js = sensor_jacobian[..., None, :]                 # (..., 1, 3)
    sensor_term = (js[..., 0] ** 2 + js[..., 1] ** 2) * var_lat \
        + js[..., 2] ** 2 * var_norm

    # J_q = p_mul_c_bm_t @ (skew(c_sb_t @ r) + b_r_bs_skew) per point
    c = operand(c_sb_t[..., None, :, :])               # (..., 1, 3, 3)
    points = operand(points)
    sp = (points[..., 0:1] * c[..., 0] + points[..., 1:2] * c[..., 1]
          + points[..., 2:3] * c[..., 2])              # (..., N, 3) = r c^T
    pm = p_mul_c_bm_t[..., None, :]                    # (..., 1, 3)
    bs = b_r_bs_skew[..., None, :, :]                  # (..., 1, 3, 3)
    s0, s1, s2 = sp[..., 0], sp[..., 1], sp[..., 2]
    p0, p1, p2 = pm[..., 0], pm[..., 1], pm[..., 2]
    # skew(sp) + bs, row i column j; jq_j = sum_i pm_i * M_ij
    jq0 = p0 * bs[..., 0, 0] + p1 * (s2 + bs[..., 1, 0]) \
        + p2 * (-s1 + bs[..., 2, 0])
    jq1 = p0 * (-s2 + bs[..., 0, 1]) + p1 * bs[..., 1, 1] \
        + p2 * (s0 + bs[..., 2, 1])
    jq2 = p0 * (s1 + bs[..., 0, 2]) + p1 * (-s0 + bs[..., 1, 2]) \
        + p2 * bs[..., 2, 2]
    jq = (jq0, jq1, jq2)
    sq = rotation_variance[..., None, :, :]
    rot_term = sum(jq[i] * sq[..., i, j] * jq[j]
                   for i in range(3) for j in range(3))
    return rot_term + sensor_term


def jacobian_ingredients(rotation_map_to_base, rotation_base_to_sensor,
                         translation_base_to_sensor):
    """Frame-dependent pieces of the propagation (readcomputerparam,
    SensorProcessorBase.cpp:270-290).

    Returns (sensor_jacobian, c_sb_t, p_mul_c_bm_t, b_r_bs_skew)."""
    R_mb = rotation_map_to_base.to(torch.float32)
    R_bs = rotation_base_to_sensor.to(torch.float32)
    t = translation_base_to_sensor.to(torch.float32)
    c_bm_t = R_mb.transpose(-1, -2)
    c_sb_t = R_bs.transpose(-1, -2)
    # P = e_z: P @ M is row 2 of M
    p_mul_c_bm_t = c_bm_t[..., 2, :].clone()
    sensor_jacobian = _vecmat(p_mul_c_bm_t, c_sb_t)
    z = torch.zeros_like(t[..., 0])
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
    b_r_bs_skew = torch.stack([
        torch.stack([z, -t2, t1], dim=-1),
        torch.stack([t2, z, -t0], dim=-1),
        torch.stack([-t1, t0, z], dim=-1),
    ], dim=-2)
    return sensor_jacobian, c_sb_t, p_mul_c_bm_t, b_r_bs_skew
