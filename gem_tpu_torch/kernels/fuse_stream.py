"""Streaming sorted-point fusion: one sort, one per-cell aggregate pass,
one dense posterior.

Counterpart of gem_tpu/kernels/fuse_stream.py `fuse_stream` in its default
configuration (2-key sort, the `fact` aggregate kernel).  The contract:

1.  Points are sorted stably by (cell, -h).  Here that is ONE stable
    `torch.sort` of a packed int64 key: the cell in the high 32 bits, the
    order-preserving uint32 image of -h in the low 32.  Stability makes the
    first point in batch order win an exact height tie, the reference
    G_fuse rule.  Invalid lanes get cell = L*L, h = 0, v = 1 and zero
    payloads first, so NaN points stay inert.
2.  Per cell, 16 aggregate rows (`fuse_stream_aggregate`, CUDA kernel K1 in
    csrc/fuse_stream.cu beside its plain PyTorch version here):

      0 st_h   h of the start row (the cell's highest point)
      1 st_v   its variance
      2 st_n   1 if the cell has any point
      3        unused (0)
      4 W      sum of 1/max(v, 1e-9) over inliers
      5 WH     sum of h/max(v, 1e-9) over inliers
      6 st_out 1 if the start row is an outlier
      7 oc_n   1 if the start row is an outlier and colored
      8 oc_v   its variance
      9 oc_c   its packed color (as an exact float: rgb < 2^24)
     10 oc_i   its intensity
     11 low    h + 3v of the end row (the cell's lowest point)
     12 vc     min v over colored inliers           (+inf if none)
     13 colf   min packed color among the vc ties   (+inf)
     14 inten  min intensity among the vc ties      (+inf)
     15        unused (+inf)

    Inliers pass |h - anchor| <= mahalanobis_threshold * sqrt(anchor_v);
    the anchor is the prior (variance clamped to min_variance), or the
    start row when the cell is empty.
3.  The dense posterior (Kalman / init / overwrite-if-higher / color) is
    elementwise tensor code, line for line the JAX one, and the storage-
    indexed `lowest` bound is rolled to the geographic layout.
"""

from __future__ import annotations

import torch

from gem_tpu_torch.core.index_math import roll_to_geo
from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels import _build
from gem_tpu_torch.kernels.pointproc import PointBatch

_WEIGHT_EPS = 1e-9
_STATS = 16
_INF = float("inf")


def _neg_height_key(h):
    """Order-preserving uint32 image of -h, held in int64.  -0.0 and +0.0
    map to one key, as lax.sort's canonicalizing comparator treats them."""
    bits = (-h + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits & 0x80000000) != 0
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


def sort_points(batch: PointBatch, ncell: int, with_color: bool = True):
    """Stable (cell, -h) sort of the batch with sanitized invalid lanes.

    Returns (offsets (ncell+1,) int64 per-cell run starts, h, v, inten,
    colf), the payloads float32 in sorted order."""
    valid = batch.valid
    ids = torch.where(valid, batch.cell.to(torch.int64), ncell)
    h = torch.where(valid, batch.height, 0.0)
    v = torch.where(valid, batch.variance, 1.0)
    key = (ids << 32) | _neg_height_key(h)
    key_s, perm = torch.sort(key, stable=True)
    ids_s = key_s >> 32
    offsets = torch.searchsorted(
        ids_s, torch.arange(ncell + 1, device=ids.device, dtype=torch.int64),
        side="left")
    if with_color:
        inten = torch.where(valid, batch.intensity, 0.0)
        colf = batch.color.to(torch.float32)       # packed rgb < 2^24: exact
        inten_s, colf_s = inten[perm], colf[perm]
    else:
        inten_s = colf_s = torch.zeros_like(h)
    return offsets, h[perm], v[perm], inten_s, colf_s


def _has_color(colf, inten):
    c = colf.to(torch.int32)
    return ((((c >> 16) & 0xFF) * ((c >> 8) & 0xFF) * (c & 0xFF)) != 0) \
        & (inten != 0)


def fuse_stream_aggregate_plain(offsets, h, v, inten, colf, elev0, var0,
                                mcfg, with_lowest: bool = True,
                                with_color: bool = True):
    """Plain PyTorch version of K1: the 16 aggregate rows (16, ncell) from
    sorted points (see the module docstring for the rows)."""
    ncell = offsets.numel() - 1
    dev = h.device
    counts = offsets[1:] - offsets[:-1]
    m = int(offsets[-1])
    ids = torch.repeat_interleave(
        torch.arange(ncell, device=dev), counts, output_size=m)
    h, v, inten, colf = h[:m], v[:m], inten[:m], colf[:m]

    out = torch.zeros((_STATS, ncell), dtype=torch.float32, device=dev)
    out[12:] = _INF
    if m == 0:
        return out
    occ = counts > 0
    # run ends of empty cells point at a neighbour's row; `occ` masks them
    first = torch.clamp(offsets[:-1], max=m - 1)
    last = torch.clamp(offsets[1:] - 1, min=0)
    zero = torch.zeros(ncell, dtype=torch.float32, device=dev)
    st_h = torch.where(occ, h[first], zero)
    st_v = torch.where(occ, v[first], zero)

    empty = elev0 == mcfg.invalid_elevation
    anchor_e = torch.where(empty, st_h, elev0)
    anchor_v = torch.where(empty, torch.clamp(st_v, min=mcfg.min_variance),
                           torch.clamp(var0, min=mcfg.min_variance))
    band = mcfg.mahalanobis_threshold * torch.sqrt(anchor_v)
    inl = torch.abs(h - anchor_e[ids]) <= band[ids]
    w = 1.0 / torch.clamp(v, min=_WEIGHT_EPS)
    pz = torch.zeros_like(h)
    W = zero.clone().index_add_(0, ids, torch.where(inl, w, pz))
    WH = zero.clone().index_add_(0, ids, torch.where(inl, w * h, pz))
    st_out = occ & ~inl[first]

    out[0], out[1], out[2] = st_h, st_v, occ.to(torch.float32)
    out[4], out[5], out[6] = W, WH, st_out.to(torch.float32)
    if with_lowest:
        out[11] = torch.where(occ, h[last] + 3.0 * v[last], zero)
    if with_color:
        hc = _has_color(colf, inten)
        oc = st_out & hc[first]
        out[7] = oc.to(torch.float32)
        out[8] = torch.where(oc, st_v, zero)
        out[9] = torch.where(oc, colf[first], zero)
        out[10] = torch.where(oc, inten[first], zero)
        contrib = inl & hc
        pinf = torch.full_like(h, _INF)
        vc = torch.full((ncell,), _INF, device=dev).scatter_reduce_(
            0, ids, torch.where(contrib, v, pinf), "amin")
        tie = contrib & (v == vc[ids])
        out[12] = vc
        out[13] = torch.full((ncell,), _INF, device=dev).scatter_reduce_(
            0, ids, torch.where(tie, colf, pinf), "amin")
        out[14] = torch.full((ncell,), _INF, device=dev).scatter_reduce_(
            0, ids, torch.where(tie, inten, pinf), "amin")
    return out


def fuse_stream_aggregate(offsets, h, v, inten, colf, elev0, var0, mcfg,
                          with_lowest: bool = True, with_color: bool = True):
    """The 16 per-cell aggregate rows, (16, ncell) float32.

    CPU tensors run `fuse_stream_aggregate_plain`; CUDA tensors launch K1
    (csrc/fuse_stream.cu) and count the launch in
    `fuse_stream_aggregate.launches`."""
    if h.device.type == "cpu":
        return fuse_stream_aggregate_plain(offsets, h, v, inten, colf, elev0,
                                           var0, mcfg, with_lowest,
                                           with_color)
    if h.device.type != "cuda":
        raise ValueError(f"fuse_stream_aggregate: unsupported device "
                         f"{h.device}")
    ncell = offsets.numel() - 1
    f32 = torch.float32
    _build.check_tensors("fuse_stream_aggregate",
                [h, offsets, v, inten, colf, elev0, var0],
                [f32, torch.int64, f32, f32, f32, f32, f32])
    if elev0.numel() != ncell or var0.numel() != ncell:
        raise ValueError("fuse_stream_aggregate: prior planes must hold "
                         "ncell = offsets.numel() - 1 cells")
    out = torch.empty((_STATS, ncell), dtype=f32, device=h.device)
    lib = _build.library()
    err = lib.gem_fuse_stream_aggregate(
        offsets.data_ptr(), h.data_ptr(), v.data_ptr(), inten.data_ptr(),
        colf.data_ptr(), elev0.data_ptr(), var0.data_ptr(), out.data_ptr(),
        ncell, mcfg.invalid_elevation, mcfg.min_variance,
        mcfg.mahalanobis_threshold, int(with_lowest), int(with_color),
        _build.stream_of(h))
    _build.check(err, "gem_fuse_stream_aggregate")
    fuse_stream_aggregate.launches += 1
    return out


fuse_stream_aggregate.launches = 0


def fuse_stream(state: MapState, cfg, batch: PointBatch,
                with_lowest: bool = True,
                with_color: bool = True) -> MapState:
    """Fuse a processed point batch into the map; also updates `lowest`
    (when `with_lowest`) from the same sorted stream."""
    L = cfg.map.length
    sorted_pts = sort_points(batch, L * L, with_color)
    s = fuse_stream_aggregate(*sorted_pts, state.elevation.reshape(-1),
                              state.variance.reshape(-1), cfg.map,
                              with_lowest, with_color)
    return apply_aggregates(state, cfg, s, with_lowest, with_color)


def apply_aggregates(state: MapState, cfg, s, with_lowest: bool = True,
                     with_color: bool = True) -> MapState:
    """The dense posterior from the 16 aggregate rows `s` (line for line
    gem_tpu's), and the lowest bound rolled to the geographic layout."""
    mcfg = cfg.map
    L = mcfg.length
    elev0f = state.elevation.reshape(-1)
    var0f = state.variance.reshape(-1)
    st_h, st_v, st_n = s[0], s[1], s[2]
    W, WH, st_out = s[4], s[5], s[6]
    oc_n, oc_v, oc_c, oc_i = s[7], s[8], s[9], s[10]
    vc_in, col_in, int_in, low_sum = s[12], s[13], s[14], s[11]

    empty = elev0f == mcfg.invalid_elevation
    var0c = torch.clamp(var0f, min=mcfg.min_variance)
    any_candidate = st_n > 0.0
    any_inlier = W > 0.0
    V_star = 1.0 / torch.clamp(W, min=_WEIGHT_EPS)
    H_star = WH * V_star
    init_path = empty & any_candidate
    kalman_path = ~empty & any_inlier
    k_elev = (var0c * H_star + V_star * elev0f) / (var0c + V_star)
    k_var = var0c * V_star / (var0c + V_star)
    post_elev = torch.where(init_path, H_star,
                            torch.where(kalman_path, k_elev, elev0f))
    post_var = torch.where(init_path, V_star,
                           torch.where(kalman_path, k_var, var0f))
    overwrite = (st_out > 0.0) & (st_h > post_elev) & ~empty
    new_elev = torch.where(overwrite, st_h, post_elev)
    new_var = torch.clamp(torch.where(overwrite, st_v, post_var),
                          min=mcfg.min_variance)
    new_state = state.replace(elevation=new_elev.reshape(L, L),
                              variance=new_var.reshape(L, L))

    if with_color:
        v_c = torch.where(overwrite,
                          torch.where(oc_n > 0.0, oc_v, _INF), vc_in)
        best_color = torch.where(overwrite, oc_c, col_in)
        best_inten = torch.where(overwrite, oc_i, int_in)
        color_update = torch.isfinite(v_c) & (init_path | kalman_path
                                              | overwrite)
        new_state = new_state.replace(
            color=torch.where(color_update, best_color.to(torch.int32),
                              state.color.reshape(-1)).reshape(L, L),
            intensity=torch.where(color_update, best_inten,
                                  state.intensity.reshape(-1)
                                  ).reshape(L, L))

    if with_lowest:
        # storage-indexed per-cell bound -> geographic layout; unoccupied
        # cells decode to +inf
        low = torch.where(any_candidate, low_sum, _INF)
        low_geo = roll_to_geo(low.reshape(L, L), state.start)
        new_state = new_state.replace(
            lowest=torch.minimum(state.lowest, low_geo))
    return new_state
