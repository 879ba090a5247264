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

Robot axis (the fleet, JAX's `vmap` of `fuse_stream`): a state with planes
(R, L, L) and a batch of (R, P) points.  Each robot's points are padded to
P_pad, a multiple of 16, and keyed by r * (L*L + 1) + cell, so one stable
sort puts robot r's points at r * P_pad of the flat (R * P_pad,)
payloads, in the order a sort of its own gives (an invalid lane's L*L
never names another robot's cell); the offsets are (R, L*L + 1),
absolute into them.  K1 then takes the robots as a grid axis and returns
(R, 16, L*L) rows, one launch for the fleet.
"""

from __future__ import annotations

import torch

from benchmark.reference.index_math import roll_to_geo
from benchmark.reference.state import MapState
from benchmark.reference.pointproc import PointBatch

_WEIGHT_EPS = 1e-9
_STATS = 16
_INF = float("inf")


def _neg_height_key(h):
    """Order-preserving uint32 image of -h, held in int64.  -0.0 and +0.0
    map to one key, as lax.sort's canonicalizing comparator treats them."""
    bits = (-h + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits & 0x80000000) != 0
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


_PAD = 16   # a robot's sorted points start on a multiple of this


def sort_points(batch: PointBatch, ncell: int, with_color: bool = True):
    """Stable (cell, -h) sort of the batch with sanitized invalid lanes.

    For a (P,) batch: (offsets (ncell+1,) int64 per-cell run starts, h, v,
    inten, colf), the payloads (P,) float32 in sorted order.  For a batch
    with a leading robot axis, (R, P): each robot padded with invalid
    lanes to P_pad (a multiple of 16) and sorted as on its own, the
    payloads flat (R * P_pad,) and the offsets (R, ncell+1), absolute
    into them."""
    valid = batch.valid
    ids = torch.where(valid, batch.cell.to(torch.int64), ncell)
    # the payload columns h, v (, intensity, packed color), each with the
    # value of an invalid lane
    cols = [(torch.where(valid, batch.height, 0.0), 0.0),
            (torch.where(valid, batch.variance, 1.0), 1.0)]
    if with_color:
        cols += [(torch.where(valid, batch.intensity, 0.0), 0.0),
                 # packed rgb < 2^24: exact
                 (batch.color.to(torch.float32), 0.0)]
    lead = ids.shape[:-1]
    if lead:
        ids = ids.reshape(-1, ids.shape[-1])
        cols = [(c.reshape(ids.shape), fill) for c, fill in cols]
        pad = (-ids.shape[-1]) % _PAD
        if pad:
            ids = torch.nn.functional.pad(ids, (0, pad), value=ncell)
            cols = [(torch.nn.functional.pad(c, (0, pad), value=fill), fill)
                    for c, fill in cols]
        # robot r's ids at r * (ncell + 1): one sort puts the robots one
        # after another, each in the order a sort of its own gives
        nrob = ids.shape[0]
        ids = (ids + (ncell + 1) * torch.arange(
            nrob, device=ids.device)[:, None]).reshape(-1)
        cols = [(c.reshape(-1), fill) for c, fill in cols]
    key = (ids << 32) | _neg_height_key(cols[0][0])
    key_s, perm = torch.sort(key, stable=True)
    nseg = (ncell + 1) * (nrob if lead else 1)
    offsets = torch.searchsorted(key_s >> 32, torch.arange(
        nseg, device=ids.device, dtype=torch.int64), side="left")
    if lead:
        offsets = offsets.reshape(nrob, ncell + 1)
    out = [c[perm] for c, _ in cols]
    if not with_color:
        out += [torch.zeros_like(out[0])] * 2
    return (offsets, *out)


def _has_color(colf, inten):
    c = colf.to(torch.int32)
    return ((((c >> 16) & 0xFF) * ((c >> 8) & 0xFF) * (c & 0xFF)) != 0) \
        & (inten != 0)


def fuse_stream_aggregate_plain(offsets, h, v, inten, colf, elev0, var0,
                                mcfg, with_lowest: bool = True,
                                with_color: bool = True):
    """Plain PyTorch version of K1: the 16 aggregate rows (16, ncell) from
    sorted points (see the module docstring for the rows); with (R,
    ncell+1) offsets and (R, ncell) priors, (R, 16, ncell), robot r's runs
    read from the flat payloads where its offsets say."""
    single = offsets.dim() == 1
    offsets = offsets.reshape(-1, offsets.shape[-1])
    nrob, ncell = offsets.shape[0], offsets.shape[1] - 1
    dev = h.device
    starts = offsets[:, :-1].reshape(-1)
    ends = offsets[:, 1:].reshape(-1)
    counts = ends - starts
    m = int(counts.sum())
    # the global cell (r * ncell + c) of every point that lies in a cell,
    # in sorted order, and its position in the payloads
    ids = torch.repeat_interleave(
        torch.arange(nrob * ncell, device=dev), counts, output_size=m)
    run0 = torch.cumsum(counts, 0) - counts
    pos = starts[ids] + torch.arange(m, device=dev) - run0[ids]
    hp, vp = h[pos], v[pos]

    out = torch.zeros((nrob, _STATS, ncell), dtype=torch.float32, device=dev)
    out[:, 12:] = _INF
    if m == 0:
        return out[0] if single else out
    occ = counts > 0
    # run ends of empty cells point at a neighbour's row; `occ` masks them
    n = h.shape[0]
    first = torch.clamp(starts, max=n - 1)
    last = torch.clamp(ends - 1, min=0)
    zero = torch.zeros(nrob * ncell, dtype=torch.float32, device=dev)
    st_h = torch.where(occ, h[first], zero)
    st_v = torch.where(occ, v[first], zero)

    elev0, var0 = elev0.reshape(-1), var0.reshape(-1)
    empty = elev0 == mcfg.invalid_elevation
    anchor_e = torch.where(empty, st_h, elev0)
    anchor_v = torch.where(empty, torch.clamp(st_v, min=mcfg.min_variance),
                           torch.clamp(var0, min=mcfg.min_variance))
    band = mcfg.mahalanobis_threshold * torch.sqrt(anchor_v)
    inl = torch.abs(hp - anchor_e[ids]) <= band[ids]
    w = 1.0 / torch.clamp(vp, min=_WEIGHT_EPS)
    pz = torch.zeros_like(hp)
    W = zero.clone().index_add_(0, ids, torch.where(inl, w, pz))
    WH = zero.clone().index_add_(0, ids, torch.where(inl, w * hp, pz))
    # the start row's gate: its point is the first of its run
    st_in = torch.abs(st_h - anchor_e) <= band
    st_out = occ & ~st_in

    rows = {0: st_h, 1: st_v, 2: occ.to(torch.float32), 4: W, 5: WH,
            6: st_out.to(torch.float32)}
    if with_lowest:
        rows[11] = torch.where(occ, h[last] + 3.0 * v[last], zero)
    if with_color:
        ip, cp = inten[pos], colf[pos]
        hc = _has_color(cp, ip)
        st_c, st_i = colf[first], inten[first]
        oc = st_out & _has_color(st_c, st_i)
        rows[7] = oc.to(torch.float32)
        rows[8] = torch.where(oc, st_v, zero)
        rows[9] = torch.where(oc, st_c, zero)
        rows[10] = torch.where(oc, st_i, zero)
        contrib = inl & hc
        pinf = torch.full_like(hp, _INF)
        full = lambda: torch.full((nrob * ncell,), _INF, device=dev)
        vc = full().scatter_reduce_(0, ids, torch.where(contrib, vp, pinf),
                                    "amin")
        tie = contrib & (vp == vc[ids])
        rows[12] = vc
        rows[13] = full().scatter_reduce_(
            0, ids, torch.where(tie, cp, pinf), "amin")
        rows[14] = full().scatter_reduce_(
            0, ids, torch.where(tie, ip, pinf), "amin")
    for k, row in rows.items():
        out[:, k] = row.reshape(nrob, ncell)
    return out[0] if single else out


# called with ("fuse_stream_aggregate", the run offsets) before each
# aggregate when set: the benchmark counts the kernel's bytes from them
PROBE = None


def fuse_stream_aggregate(offsets, h, v, inten, colf, elev0, var0, mcfg,
                          with_lowest: bool = True, with_color: bool = True):
    """The 16 per-cell aggregate rows, by the plain version on any device."""
    return fuse_stream_aggregate_plain(offsets, h, v, inten, colf, elev0,
                                       var0, mcfg, with_lowest, with_color)


def fuse_stream(state: MapState, cfg, batch: PointBatch,
                with_lowest: bool = True,
                with_color: bool = True) -> MapState:
    """Fuse a processed point batch into the map; also updates `lowest`
    (when `with_lowest`) from the same sorted stream.  A state and batch
    with a leading robot axis fuse every robot in one K1 launch."""
    L = cfg.map.length
    sorted_pts = sort_points(batch, L * L, with_color)
    if PROBE is not None:
        PROBE("fuse_stream_aggregate", sorted_pts[0])
    lead = state.elevation.shape[:-2]
    s = fuse_stream_aggregate(*sorted_pts, state.elevation.reshape(
        lead + (L * L,)), state.variance.reshape(lead + (L * L,)), cfg.map,
        with_lowest, with_color)
    return apply_aggregates(state, cfg, s, with_lowest, with_color)


def apply_aggregates(state: MapState, cfg, s, with_lowest: bool = True,
                     with_color: bool = True) -> MapState:
    """The dense posterior from the 16 aggregate rows `s`, (..., 16, L*L)
    (line for line gem_tpu's), and the lowest bound rolled to the
    geographic layout."""
    mcfg = cfg.map
    shape = state.elevation.shape
    elev0f = state.elevation.flatten(-2)
    var0f = state.variance.flatten(-2)
    row = lambda k: s[..., k, :]
    st_h, st_v, st_n = row(0), row(1), row(2)
    W, WH, st_out = row(4), row(5), row(6)
    oc_n, oc_v, oc_c, oc_i = row(7), row(8), row(9), row(10)
    vc_in, col_in, int_in, low_sum = row(12), row(13), row(14), row(11)

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
    new_state = state.replace(elevation=new_elev.reshape(shape),
                              variance=new_var.reshape(shape))

    if with_color:
        v_c = torch.where(overwrite,
                          torch.where(oc_n > 0.0, oc_v, _INF), vc_in)
        best_color = torch.where(overwrite, oc_c, col_in)
        best_inten = torch.where(overwrite, oc_i, int_in)
        color_update = torch.isfinite(v_c) & (init_path | kalman_path
                                              | overwrite)
        new_state = new_state.replace(
            color=torch.where(color_update, best_color.to(torch.int32),
                              state.color.flatten(-2)).reshape(shape),
            intensity=torch.where(color_update, best_inten,
                                  state.intensity.flatten(-2)
                                  ).reshape(shape))

    if with_lowest:
        # storage-indexed per-cell bound -> geographic layout; unoccupied
        # cells decode to +inf
        low = torch.where(any_candidate, low_sum, _INF)
        low_geo = roll_to_geo(low.reshape(shape), state.start)
        new_state = new_state.replace(
            lowest=torch.minimum(state.lowest, low_geo))
    return new_state
