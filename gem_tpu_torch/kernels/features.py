"""Terrain features: 5x5 plane fit -> normal, slope, roughness, traversability.

Counterpart of gem_tpu/kernels/features.py (the plain version: 25 rolled
copies of the circular elevation buffer, masked moment sums, closed-form
3x3 eigensolver) and of gem_tpu/kernels/features_pallas.py (the stencil
kernel).  `plane_fit_features` is the kernel wrapper: on CPU tensors it runs
`compute_features`, on CUDA tensors it launches K2 (csrc/features.cu).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels import _build
from gem_tpu_torch.utils.precision import f32_recip

_MOMENTS = ("n", "Sx", "Sy", "Sz", "Sxx", "Syy", "Sxy", "Sxz", "Syz", "Szz")


@dataclasses.dataclass(frozen=True)
class FeatureMaps:
    slope: torch.Tensor
    rough: torch.Tensor
    traver: torch.Tensor
    normal_z: torch.Tensor
    neighbor_count: torch.Tensor   # int32


def _smallest_eig_normal(xx, xy, xz, yy, yz, zz):
    """|z| of the unit eigenvector of the smallest eigenvalue of the
    symmetric matrix [[xx,xy,xz],[xy,yy,yz],[xz,yz,zz]]; closed-form
    trigonometric method, elementwise."""
    # x / constant is x * f32_recip(constant), XLA's rounding
    third = f32_recip(3.0)
    q = (xx + yy + zz) * third
    p1 = xy * xy + xz * xz + yz * yz
    dx, dy, dz = xx - q, yy - q, zz - q
    p2 = dx * dx + dy * dy + dz * dz + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 * f32_recip(6.0), min=1e-30))
    bxx, byy, bzz = dx / p, dy / p, dz / p
    bxy, bxz, byz = xy / p, xz / p, yz / p
    detb = (bxx * (byy * bzz - byz * byz)
            - bxy * (bxy * bzz - byz * bxz)
            + bxz * (bxy * byz - byy * bxz))
    r = torch.clamp(detb * 0.5, -1.0, 1.0)
    phi = torch.acos(r) * third
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    r0 = (xx - lam, xy, xz)
    r1 = (xy, yy - lam, yz)
    r2 = (xz, yz, zz - lam)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    sq = lambda c: c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
    n01, n02, n12 = sq(c01), sq(c02), sq(c12)
    best = torch.maximum(torch.maximum(n01, n02), n12)
    pick = lambda k: torch.where(best == n01, c01[k],
                                 torch.where(best == n02, c02[k], c12[k]))
    vx, vy, vz = pick(0), pick(1), pick(2)
    norm = torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-30))
    degenerate = (p2 < 1e-12) | (best < 1e-20)
    return torch.where(degenerate, 1.0, torch.abs(vz) / norm)


def features_from_moments(acc: dict, interior_elev, cfg):
    """Moment sums -> (slope, rough, traver, nz, ok); `cfg` is a
    MapConfig."""
    n_safe = torch.clamp(acc["n"], min=1.0)
    xx = acc["Sxx"] - acc["Sx"] * acc["Sx"] / n_safe
    yy = acc["Syy"] - acc["Sy"] * acc["Sy"] / n_safe
    zz = acc["Szz"] - acc["Sz"] * acc["Sz"] / n_safe
    xy = acc["Sxy"] - acc["Sx"] * acc["Sy"] / n_safe
    xz = acc["Sxz"] - acc["Sx"] * acc["Sz"] / n_safe
    yz = acc["Syz"] - acc["Sy"] * acc["Sz"] / n_safe

    nz = _smallest_eig_normal(xx, xy, xz, yy, yz, zz)
    slope = torch.acos(torch.clamp(nz, 0.0, 1.0))
    rough = torch.abs(interior_elev - acc["Sz"] / n_safe)
    traver = (0.5 * (1.0 - slope * f32_recip(cfg.slope_critical))
              + 0.5 * (1.0 - rough * f32_recip(cfg.rough_critical)))
    ok = (interior_elev != cfg.invalid_elevation) \
        & (acc["n"] >= cfg.feature_min_neighbors)
    return (torch.where(ok, slope, 0.0), torch.where(ok, rough, 0.0),
            torch.where(ok, traver, cfg.invalid_traversability),
            torch.where(ok, nz, 1.0), ok)


def accumulate_moments(z_at, row_ok, col_ok, shape, device, cfg) -> dict:
    """The masked 5x5 moment sums of the plane fit over a `shape` block:
    `z_at(i, j)` is the elevation at offset (i, j) of every cell,
    `row_ok(i)` (rows,) and `col_ok(j)` (cols,) say where that offset lies
    inside the map; `cfg` is a MapConfig.  Shared by `compute_features`
    and the row-sharded stencil (multirobot/spatial.py), which must agree
    bitwise."""
    res = cfg.resolution
    acc = {k: torch.zeros(shape, dtype=torch.float32, device=device)
           for k in _MOMENTS}
    for i in range(-2, 3):
        rows_in = row_ok(i)
        for j in range(-2, 3):
            z = z_at(i, j)
            m = (rows_in[:, None] & col_ok(j)[None, :]
                 & (z != cfg.invalid_elevation)).to(torch.float32)
            cx = i * res
            cy = j * res
            mz = m * z
            acc["n"] += m
            acc["Sx"] += m * cx
            acc["Sy"] += m * cy
            acc["Sz"] += mz
            acc["Sxx"] += m * (cx * cx)
            acc["Syy"] += m * (cy * cy)
            acc["Sxy"] += m * (cx * cy)
            acc["Sxz"] += mz * cx
            acc["Syz"] += mz * cy
            acc["Szz"] += mz * z
    return acc


def compute_features(state: MapState, cfg) -> FeatureMaps:
    """Plain PyTorch version of K2 (`cfg` is a MapConfig)."""
    L = cfg.length
    elev = state.elevation
    rows = torch.arange(L, device=elev.device)
    geo_r = torch.remainder(rows - state.start[0] + L, L)
    geo_c = torch.remainder(rows - state.start[1] + L, L)
    acc = accumulate_moments(
        lambda i, j: torch.roll(elev, shifts=(-i, -j), dims=(0, 1)),
        lambda i: (geo_r + i >= 0) & (geo_r + i < L),
        lambda j: (geo_c + j >= 0) & (geo_c + j < L), (L, L),
        elev.device, cfg)
    slope, rough, traver, nz, _ = features_from_moments(acc, elev, cfg)
    return FeatureMaps(slope=slope, rough=rough, traver=traver, normal_z=nz,
                       neighbor_count=acc["n"].to(torch.int32))


@functools.lru_cache(maxsize=None)
def _offset_table(res: float) -> np.ndarray:
    """K2's float[40] table of the 5x5 offsets (the `Offsets` struct of
    csrc/features.cu): c[k] = f32(k*res) and cc[k] = f32((k*res)^2) for
    k = -2..2, cxy[i][j] = f32((i*res)*(j*res)), then the sums Sx, Sy, Sxx,
    Syy, Sxy over all 25 offsets in `compute_features`'s (i, j) order.  The
    products are formed in double and rounded to float once, as PyTorch
    rounds the Python scalars of the plain version; the sums add in float."""
    ks = range(-2, 3)
    c = np.array([k * res for k in ks], np.float32)
    cc = np.array([(k * res) * (k * res) for k in ks], np.float32)
    cxy = np.array([(i * res) * (j * res) for i in ks for j in ks],
                   np.float32)
    full = np.zeros(5, np.float32)        # Sx, Sy, Sxx, Syy, Sxy
    for i in range(5):
        for j in range(5):
            terms = np.array([c[i], c[j], cc[i], cc[j], cxy[5 * i + j]],
                             np.float32)
            full = full + terms            # float32 adds, one per offset
    return np.concatenate([c, cc, cxy, full]).astype(np.float32)


def plane_fit_features(state: MapState, cfg) -> FeatureMaps:
    """Five feature planes of the 5x5 plane fit.  CPU tensors run
    `compute_features`; CUDA tensors launch K2 and count the launch in
    `plane_fit_features.launches`."""
    elev = state.elevation
    if elev.device.type == "cpu":
        return compute_features(state, cfg)
    if elev.device.type != "cuda":
        raise ValueError(f"plane_fit_features: unsupported device "
                         f"{elev.device}")
    L = cfg.length
    if elev.shape != (L, L) or elev.dtype != torch.float32 \
            or not elev.is_contiguous():
        raise ValueError("plane_fit_features: elevation must be a "
                         f"contiguous float32 ({L}, {L}) tensor")
    start = state.start
    if start.dtype != torch.int32 or start.device != elev.device \
            or start.shape != (2,) or not start.is_contiguous():
        raise ValueError("plane_fit_features: start must be a contiguous "
                         "int32 (2,) tensor on the elevation's device")
    planes = torch.empty((4, L, L), dtype=torch.float32, device=elev.device)
    count = torch.empty((L, L), dtype=torch.int32, device=elev.device)
    lib = _build.library()
    err = lib.gem_plane_fit_features(
        elev.data_ptr(), start.data_ptr(), planes[0].data_ptr(),
        planes[1].data_ptr(), planes[2].data_ptr(), planes[3].data_ptr(),
        count.data_ptr(), L, _offset_table(float(cfg.resolution)).ctypes.data,
        cfg.invalid_elevation,
        cfg.invalid_traversability, f32_recip(cfg.slope_critical),
        f32_recip(cfg.rough_critical),
        float(cfg.feature_min_neighbors), _build.stream_of(elev))
    _build.check(err, "gem_plane_fit_features")
    plane_fit_features.launches += 1
    return FeatureMaps(slope=planes[0], rough=planes[1], traver=planes[2],
                       normal_z=planes[3], neighbor_count=count)


plane_fit_features.launches = 0
