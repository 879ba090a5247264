"""DiSCO-style place recognition signatures for inter-robot loop search.

Counterpart of gem_tpu/global_map/place_recognition.py.  The reference only
defines the message contracts (dislam_msgs/DiSCO.msg) and delegates the
computation to the external MR_SLAM backend; here:

  1. rasterise a submap's points into a polar BEV height image
     (rings x sectors) around a center;
  2. the azimuthal FFT magnitude spectrum per ring is the rotation-invariant
     signature (a yaw rotation is a circular shift over sectors);
  3. the full per-ring spectra recover the relative yaw between two matching
     places by phase correlation.

Divisions by the constants `max_radius` and 2*pi follow the reference's
jitted caller (multirobot/loop_detect.py): multiplication by the f32
reciprocal.
"""

from __future__ import annotations

import math

import torch

from gem_tpu_torch.global_map.submaps import PointBuffer
from gem_tpu_torch.utils.precision import f32_recip


def polar_bev(buf: PointBuffer, center_xy, max_radius: float,
              n_rings: int = 32, n_sectors: int = 64):
    """(n_rings, n_sectors) height image of a submap around `center_xy`:
    bin value = 1 + (max z in bin - submap min z), empty = 0."""
    dx = buf.x - center_xy[0]
    dy = buf.y - center_xy[1]
    r = torch.sqrt(dx * dx + dy * dy)
    theta = torch.atan2(dy, dx)
    ring = torch.floor(r * f32_recip(max_radius) * n_rings).to(torch.int64)
    sector = torch.remainder(
        torch.floor((theta + math.pi) * f32_recip(2 * math.pi) * n_sectors)
        .to(torch.int64), n_sectors)
    ok = buf.valid & (ring >= 0) & (ring < n_rings)
    flat = torch.where(ok, ring * n_sectors + sector, n_rings * n_sectors)
    zmin = torch.where(buf.valid, buf.z, math.inf).min()
    zrel = 1.0 + buf.z - torch.where(torch.isfinite(zmin), zmin, 0.0)
    img = torch.full((n_rings * n_sectors + 1,), -math.inf,
                     dtype=torch.float32, device=buf.x.device)
    img.scatter_reduce_(0, flat, torch.where(ok, zrel, -math.inf), "amax")
    return torch.clamp(img[:-1].reshape(n_rings, n_sectors), min=0.0)


def disco_signature(buf: PointBuffer, center_xy, max_radius: float = 25.0,
                    n_rings: int = 32, n_sectors: int = 64):
    """Returns (signature, fft_real, fft_imag), each (n_rings * n_sectors,)
    f32: the per-ring azimuthal FFT magnitudes (rotation invariant) and the
    full per-ring complex spectrum."""
    img = polar_bev(buf, center_xy, max_radius, n_rings, n_sectors)
    spec = torch.fft.fft(img, dim=1)                     # (R, S) complex64
    return (spec.abs().reshape(-1), spec.real.reshape(-1).contiguous(),
            spec.imag.reshape(-1).contiguous())


def match_signatures(sig_a, sig_b):
    """Cosine similarity of two rotation-invariant signatures."""
    na = torch.linalg.vector_norm(sig_a) + 1e-9
    nb = torch.linalg.vector_norm(sig_b) + 1e-9
    return torch.dot(sig_a, sig_b) / (na * nb)


def relative_yaw(fft_a_real, fft_a_imag, fft_b_real, fft_b_imag,
                 n_sectors: int = 64):
    """Relative yaw between two places by full-spectrum phase correlation:
    every ring contributes its own phase-correlation term, weighted by its
    cross-power magnitude, and a parabola through the peak and its two
    neighbours refines the peak below one sector."""
    A = torch.complex(fft_a_real, fft_a_imag).reshape(-1, n_sectors)
    B = torch.complex(fft_b_real, fft_b_imag).reshape(-1, n_sectors)
    cross = A * torch.conj(B)
    mag = cross.abs()
    phase = cross / (mag + 1e-9)
    weight = mag / (mag.sum(dim=1, keepdim=True) + 1e-9)
    corr = torch.fft.ifft((phase * weight).sum(dim=0)).real     # (S,)
    shift = torch.argmax(corr)          # ties: the first index, as jnp
    cm = corr[(shift - 1) % n_sectors]
    c0 = corr[shift]
    cp = corr[(shift + 1) % n_sectors]
    denom = cm - 2 * c0 + cp
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (cm - cp) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    return (shift.to(torch.float32) + delta) * (2 * math.pi / n_sectors)
