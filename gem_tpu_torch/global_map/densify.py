"""Submap densification: local polynomial (MLS-style) surface upsampling.

Counterpart of gem_tpu/global_map/densify.py, which replaces the reference's
PCL MovingLeastSquares upsample (pointcloudinterpolation,
src/ElevationMapping.cpp:1072-1118; polynomial order 5):

  1. splat the submap points onto a fine regular grid (mass + height sums);
  2. per fine cell, fit a weighted polynomial surface
         z(dx, dy) = sum_k a_k dx^p_k dy^q_k,  p_k + q_k <= order
     by least squares over the Gaussian-weighted neighborhood stencil: the
     moment planes accumulate with a constant coefficient per shift, then
     one batched (G^2, K, K) Jacobi-preconditioned solve gives a0;
  3. fall back to the weighted mean where support is too thin for a fit.

The splat is a scatter-add: on CPU tensors `index_add_` adds in index order
like the reference on the CPU; on CUDA tensors it adds with atomics, so the
card's sums are order-dependent at the f32 rounding level.  The solve is
`torch.linalg.solve_ex`: it neither raises on a singular system nor reads
anything back to the host; a non-finite fit falls back to the mean.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from gem_tpu_torch.global_map.submaps import PointBuffer
from gem_tpu_torch.utils.precision import f32_recip


@functools.lru_cache(None)
def _basis(order: int):
    """Monomial basis [(p, q)] with p+q <= order, (0, 0) first."""
    return tuple((p, q) for s in range(order + 1)
                 for p in range(s, -1, -1) for q in (s - p,))


def densify_submap(buf: PointBuffer, *, base_resolution: float,
                   upsample: int = 2, radius_cells: int = 3,
                   min_support: int = 4, grid_size: int = 256,
                   origin=None, ridge: float = 1e-6, order: int = 2):
    """Return a dict of dense grid points interpolated from `buf`.

    The fine grid has `grid_size`^2 cells at base_resolution/upsample
    spacing, anchored at `origin` (defaults to the buffer's valid-point
    minimum).  Heights come from the local polynomial fit of the given
    `order` (1..5; 5 = the reference MLS default; a0 at the cell center);
    traversability/variance/color stay distance-weighted aggregates.
    """
    if not 1 <= order <= 5:
        raise ValueError(f"densify order must be 1..5, got {order}")
    basis = _basis(order)
    K = len(basis)
    res = base_resolution / upsample
    dev = buf.x.device
    if origin is None:
        big = 1e9
        origin = (torch.where(buf.valid, buf.x, big).min(),
                  torch.where(buf.valid, buf.y, big).min())

    G = grid_size
    inv_res = f32_recip(res)              # `/ res` as the reference's jit
    ix = torch.floor((buf.x - origin[0]) * inv_res).to(torch.int64)
    iy = torch.floor((buf.y - origin[1]) * inv_res).to(torch.int64)
    ok = buf.valid & (ix >= 0) & (ix < G) & (iy >= 0) & (iy < G)
    flat = torch.where(ok, ix * G + iy, G * G)

    # splat per-cell mass / sums onto the fine grid (row G*G: dump)
    def splat(vals):
        out = torch.zeros((G * G + 1,), dtype=torch.float32, device=dev)
        return out.index_add_(0, flat, vals)[:-1].reshape(G, G)

    w = ok.to(torch.float32)
    n0 = splat(w)
    z0 = splat(torch.where(ok, buf.z, 0.0))
    c0 = torch.zeros((G * G + 1,), dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, flat, buf.color.to(torch.int32), "amax")[:-1] \
        .reshape(G, G)
    t0 = splat(torch.where(ok, buf.traver, 0.0))
    v0 = splat(torch.where(ok, buf.variance, 0.0))

    # Gaussian-weighted stencil sweep, shifts zero-filled (the fine grid is
    # not circular).  Per shift (i, j) the source cell sits at the constant
    # radius-normalized offset (i/r, j/r) from the target center.
    r = radius_cells

    def shift(a, i, j):
        return F.pad(a[None, None], (r, r, r, r))[0, 0, r + i:r + i + G,
                                                  r + j:r + j + G]

    sigma2 = (radius_cells / 2.0) ** 2

    # A needs sum w dx^p dy^q for (p, q) = basis + basis (p+q <= 2*order);
    # b needs sum w z dx^p dy^q over the basis itself.
    a_pq = sorted({(pa + pb, qa + qb) for pa, qa in basis
                   for pb, qb in basis})
    zeros = lambda: torch.zeros((G, G), dtype=torch.float32, device=dev)
    M = {pq: zeros() for pq in a_pq}
    B = {pq: zeros() for pq in basis}
    n = zeros()            # total weighted mass
    nsrc = zeros()         # distinct contributing source cells
    t = zeros()
    v = zeros()
    c = torch.zeros_like(c0)
    for i in range(-r, r + 1):
        for j in range(-r, r + 1):
            wgt = math.exp(-(i * i + j * j) / (2 * sigma2))
            dx, dy = i / r, j / r
            n_ij = shift(n0, i, j)
            z_ij = shift(z0, i, j)
            for (p, q) in a_pq:
                M[(p, q)] = M[(p, q)] + (wgt * dx ** p * dy ** q) * n_ij
            for (p, q) in basis:
                B[(p, q)] = B[(p, q)] + (wgt * dx ** p * dy ** q) * z_ij
            n = n + wgt * n_ij
            nsrc = nsrc + (n_ij > 0)
            t = t + wgt * shift(t0, i, j)
            v = v + wgt * shift(v0, i, j)
            c = torch.maximum(c, shift(c0, i, j))

    # batched KxK normal-equation solve, Jacobi-preconditioned (divide by
    # sqrt(diag) on both sides) with a relative ridge
    A = torch.stack([torch.stack([M[(pa + pb, qa + qb)].reshape(-1)
                                  for pb, qb in basis], dim=-1)
                     for pa, qa in basis], dim=-2)          # (G^2, K, K)
    rhs = torch.stack([B[pq].reshape(-1) for pq in basis], dim=-1)
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1),
                               min=1e-12))
    An = A / (d[..., :, None] * d[..., None, :])
    An = An + ridge * torch.eye(K, dtype=torch.float32, device=dev)
    sol, _ = torch.linalg.solve_ex(An, (rhs / d)[..., None])
    z_fit = (sol[..., 0] / d)[:, 0].reshape(G, G)          # value at center

    support = n
    z_mean = B[(0, 0)] / torch.clamp(n, min=1e-6)

    # the fit needs >= K well-spread source cells; otherwise weighted mean
    fit_ok = (nsrc >= K) & torch.isfinite(z_fit)
    zf = torch.where(fit_ok, z_fit, z_mean)
    valid = support >= (min_support * 0.5)
    tf = t / torch.clamp(support, min=1e-6)
    vf = v / torch.clamp(support, min=1e-6)

    cells = torch.arange(G, dtype=torch.float32, device=dev) + 0.5
    gx = origin[0] + cells * res
    gy = origin[1] + cells * res
    X = gx[:, None].expand(G, G)
    Y = gy[None, :].expand(G, G)
    return dict(x=X.reshape(-1), y=Y.reshape(-1), z=zf.reshape(-1),
                variance=vf.reshape(-1), traver=tf.reshape(-1),
                color=c.reshape(-1), valid=valid.reshape(-1))
