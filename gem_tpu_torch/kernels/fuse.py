"""Per-cell Kalman / min-variance fusion, and the one entry for every fuse
backend: `fuse(state, cfg, batch, backend)` with `backend` one of
`FUSE_BACKENDS`, which also updates the per-cell `lowest` bound (when
`cfg.enable_lowest`).

Counterpart of gem_tpu/kernels/fuse.py, line for line: the anchor (the cell
prior, or the highest candidate of an empty cell), gating against it, the
product-of-Gaussians inlier combine, the Kalman posterior, the
outlier-above overwrite and the min-variance color payload.  Backends:

  * "stream" (the step's default): kernels/fuse_stream.py, whose aggregate
    pass is kernel K1 and which reads `lowest` off its sorted runs;
  * "segment" / "sort": the reductions of kernels/scatter.py;
  * "pallas": `fuse_pallas`, whose five reductions per frame go through
    `segment_stats_sorted` (kernel K3 on CUDA tensors) over one shared
    sort, with the same column stacks as the JAX version.

The last three take `lowest` from kernels/pointproc.py `lowest_bound`,
over the geographic cells recovered from the batch's storage cells.

Robot axis (JAX's `vmap` of `fuse`): a state with planes (R, L, L) and a
batch of (R, P) points.  The segment and sort backends fold robot r's ids
to r * (L*L + 1) + id (each robot keeps its own dump segment) and reduce
every robot at once; "pallas" sorts each robot's points on their own and
K3 takes the robots as a grid axis.
"""

from __future__ import annotations

import math

import torch

from gem_tpu_torch.core.index_math import storage_to_geo
from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels import scatter
from gem_tpu_torch.kernels.fuse_stream import fuse_stream
from gem_tpu_torch.kernels.pointproc import PointBatch, lowest_bound
from gem_tpu_torch.kernels.segment_stats import (pad_sort,
                                                 segment_stats_sorted)

_WEIGHT_EPS = 1e-9  # zero-variance (perfect-sensor) points dominate finitely
_INF = float("inf")
_I32_MAX = torch.iinfo(torch.int32).max


def _has_color(color, intensity):
    return ((((color >> 16) & 0xFF) * ((color >> 8) & 0xFF)
             * (color & 0xFF)) != 0) & (intensity != 0)


FUSE_BACKENDS = ("stream", "segment", "sort", "pallas")


def check_backend(backend: str) -> None:
    if backend not in FUSE_BACKENDS:
        raise ValueError(f"fuse_backend {backend!r} is not one of "
                         f"{FUSE_BACKENDS}")


def fuse(state: MapState, cfg, batch: PointBatch,
         backend: str = "segment") -> MapState:
    """Fuse a processed point batch into the map with `backend` (see the
    module docstring), `lowest` included."""
    check_backend(backend)
    if backend == "stream":
        return fuse_stream(state, cfg, batch, with_lowest=cfg.enable_lowest,
                           with_color=cfg.enable_color)
    if cfg.enable_lowest:
        # exact integer arithmetic: the geographic cell each point binned by
        L = cfg.map.length
        gx, gy = storage_to_geo(batch.cell // L, batch.cell % L,
                                state.start[..., None, :], L)
        state = state.replace(lowest=lowest_bound(
            state.lowest, gx * L + gy, batch.height, batch.variance,
            batch.valid, L))
    if backend == "pallas":
        return fuse_pallas(state, cfg, batch)
    mcfg = cfg.map
    L = mcfg.length
    ncell = L * L
    lead = state.elevation.shape[:-2]
    nrob = math.prod(lead)
    rob = torch.arange(nrob, device=batch.cell.device).reshape(lead + (1,))

    elev0 = state.elevation.reshape(-1)
    var0 = state.variance.reshape(-1)
    empty = elev0 == mcfg.invalid_elevation
    var0c = torch.clamp(var0, min=mcfg.min_variance)

    flat = lambda x: x.reshape(-1)
    valid = flat(batch.valid)
    h = flat(batch.height)
    v = flat(batch.variance)
    # robot r's ids at r * (ncell + 1), its invalid lanes on its own dump
    nseg = nrob * (ncell + 1)
    ids = flat(torch.where(batch.valid, batch.cell.to(torch.int64), ncell)
               + rob * (ncell + 1))
    ss = scatter.SortedSegments(ids, nseg, rows=nrob) \
        if backend == "sort" else None

    def reduce(vals, kind, fill):
        out = scatter.segment_reduce(vals, ids, nseg, kind, fill,
                                     backend=backend, ss=ss)
        return out.reshape(nrob, ncell + 1)[:, :ncell].reshape(-1)

    cidx = flat(torch.clamp(batch.cell, max=ncell - 1).to(torch.int64)
                + rob * ncell)
    color, intensity = flat(batch.color), flat(batch.intensity)

    # --- anchor: prior, or highest candidate for empty cells ---------------
    h_max = reduce(torch.where(valid, h, -_INF), "max", -_INF)
    any_candidate = torch.isfinite(h_max)
    p_is_argmax = valid & (h == h_max[cidx])
    v_argmax = reduce(torch.where(p_is_argmax, v, _INF), "min", _INF)
    anchor_elev = torch.where(empty, h_max, elev0)
    anchor_var = torch.where(
        empty, torch.clamp(v_argmax, min=mcfg.min_variance), var0c)

    # --- gate against the anchor -------------------------------------------
    a_var = anchor_var[cidx]
    md = torch.abs(h - anchor_elev[cidx]) / torch.sqrt(
        torch.where(torch.isfinite(a_var), a_var, 1.0))
    inlier = valid & (md <= mcfg.mahalanobis_threshold)

    # --- combined inlier measurement (product of Gaussians) ----------------
    w = 1.0 / torch.clamp(v, min=_WEIGHT_EPS)
    W = reduce(torch.where(inlier, w, 0.0), "sum", 0.0)
    WH = reduce(torch.where(inlier, w * h, 0.0), "sum", 0.0)
    post_elev, post_var, init_path, kalman_path = _posterior(
        W, WH, elev0, var0, var0c, empty, any_candidate)

    # --- outlier-above override: fresh obstacle beats ground ---------------
    out_mask = valid & ~inlier
    h_max_out = reduce(torch.where(out_mask, h, -_INF), "max", -_INF)
    p_is_argout = out_mask & (h == h_max_out[cidx])
    v_argout = reduce(torch.where(p_is_argout, v, _INF), "min", _INF)
    overwrite_path = torch.isfinite(h_max_out) & (h_max_out > post_elev) \
        & ~empty
    new_elev = torch.where(overwrite_path, h_max_out, post_elev)
    new_var = torch.clamp(torch.where(overwrite_path, v_argout, post_var),
                          min=mcfg.min_variance)

    # --- color / intensity -------------------------------------------------
    contributing = valid & _has_color(color, intensity) \
        & torch.where(overwrite_path[cidx], p_is_argout, inlier)
    v_c = reduce(torch.where(contributing, v, _INF), "min", _INF)
    p_is_cbest = contributing & (v == v_c[cidx])
    best_color = reduce(torch.where(p_is_cbest, color, _I32_MAX),
                        "min", _I32_MAX)
    best_intensity = reduce(torch.where(p_is_cbest, intensity, _INF),
                            "min", _INF)
    color_update = torch.isfinite(v_c) & (init_path | kalman_path
                                          | overwrite_path)
    return _replace(state, new_elev, new_var, color_update, best_color,
                    best_intensity)


def _posterior(W, WH, elev0, var0, var0c, empty, any_candidate):
    any_inlier = W > 0.0
    V_star = 1.0 / torch.clamp(W, min=_WEIGHT_EPS)
    H_star = WH * V_star
    init_path = empty & any_candidate
    kalman_path = ~empty & any_inlier
    k_elev = (var0c * H_star + V_star * elev0) / (var0c + V_star)
    k_var = var0c * V_star / (var0c + V_star)
    post_elev = torch.where(init_path, H_star,
                            torch.where(kalman_path, k_elev, elev0))
    post_var = torch.where(init_path, V_star,
                           torch.where(kalman_path, k_var, var0))
    return post_elev, post_var, init_path, kalman_path


def _replace(state, new_elev, new_var, color_update, best_color,
             best_intensity):
    """The fused planes, given flat over the state's cells (all of them, or
    (R, L*L)), in the state's (..., L, L) shape."""
    shape = state.elevation.shape
    flat = color_update.shape
    return state.replace(
        elevation=new_elev.reshape(shape),
        variance=new_var.reshape(shape),
        color=torch.where(color_update, best_color,
                          state.color.reshape(flat)).reshape(shape),
        intensity=torch.where(color_update, best_intensity,
                              state.intensity.reshape(flat)).reshape(shape))


def fuse_pallas(state: MapState, cfg, batch: PointBatch) -> MapState:
    """`fuse` with its reductions as five `segment_stats_sorted` calls over
    one shared sort (anchor max; argmax variance; inlier sums + outlier
    max; outlier-argmax and best-color variances; color payload), the
    column stacks of gem_tpu's `fuse_pallas`.  With a robot axis each
    robot's points are sorted on their own and each call is one K3 launch
    per four columns for every robot."""
    mcfg = cfg.map
    L = mcfg.length
    ncell = L * L

    elev0 = state.elevation.flatten(-2)
    var0 = state.variance.flatten(-2)
    empty = elev0 == mcfg.invalid_elevation
    var0c = torch.clamp(var0, min=mcfg.min_variance)

    ids = torch.where(batch.valid, batch.cell, ncell)
    cols = torch.stack([
        batch.height,
        batch.variance,
        batch.color.to(torch.float32),        # packed rgb < 2^24: f32-exact
        batch.intensity,
        _has_color(batch.color, batch.intensity).to(torch.float32),
    ])
    ids_s, cols_s = pad_sort(ids, cols, ncell)
    h, v, color_f, inten, hascol = cols_s
    valid = ids_s < ncell
    hascol = hascol > 0.5
    cidx = torch.clamp(ids_s, max=ncell - 1).to(torch.int64)
    at = lambda plane: plane.gather(-1, cidx)     # each point's cell's value
    # the (0, N) stack of a role whose result is not used: K3 skips it
    none = torch.empty((0,) + ids_s.shape, dtype=torch.float32,
                       device=ids_s.device)

    def stats(sv, mv, xv):
        return segment_stats_sorted(ids_s, sv, mv, xv, ncell,
                                    with_spill=False)

    # --- pass 1: anchor candidates -----------------------------------------
    _, _, xs, _ = stats(none, none, torch.where(valid, h, -_INF)[None])
    h_max = xs[0]
    any_candidate = torch.isfinite(h_max)
    p_is_argmax = valid & (h == at(h_max))

    # --- pass 2: v(argmax) fixes the empty-cell anchor variance ------------
    anchor_elev = torch.where(empty, h_max, elev0)
    w = 1.0 / torch.clamp(v, min=_WEIGHT_EPS)
    _, ms0, _, _ = stats(none, torch.where(p_is_argmax, v, _INF)[None],
                         none)
    anchor_var = torch.where(
        empty, torch.clamp(ms0[0], min=mcfg.min_variance), var0c)
    a_var = at(anchor_var)
    md = torch.abs(h - at(anchor_elev)) / torch.sqrt(
        torch.where(torch.isfinite(a_var), a_var, 1.0))
    inlier = valid & (md <= mcfg.mahalanobis_threshold)
    out_mask = valid & ~inlier

    # --- pass 3: inlier sums + outlier max ---------------------------------
    ss, _, xs2, _ = stats(
        torch.stack([torch.where(inlier, w, 0.0),
                     torch.where(inlier, w * h, 0.0)]),
        none, torch.where(out_mask, h, -_INF)[None])
    h_max_out = xs2[0]
    post_elev, post_var, init_path, kalman_path = _posterior(
        ss[0], ss[1], elev0, var0, var0c, empty, any_candidate)
    overwrite_path = torch.isfinite(h_max_out) & (h_max_out > post_elev) \
        & ~empty

    # --- pass 4: outlier-argmax variance + best-color variance -------------
    p_is_argout = out_mask & (h == at(h_max_out))
    contributing = valid & hascol & torch.where(at(overwrite_path),
                                                p_is_argout, inlier)
    _, ms3, _, _ = stats(
        none,
        torch.stack([torch.where(p_is_argout, v, _INF),
                     torch.where(contributing, v, _INF)]),
        none)
    v_argout, v_c = ms3[0], ms3[1]
    new_elev = torch.where(overwrite_path, h_max_out, post_elev)
    new_var = torch.clamp(torch.where(overwrite_path, v_argout, post_var),
                          min=mcfg.min_variance)

    # --- pass 5: color payload ---------------------------------------------
    p_is_cbest = contributing & (v == at(v_c))
    _, ms4, _, _ = stats(
        none,
        torch.stack([torch.where(p_is_cbest, color_f, _INF),
                     torch.where(p_is_cbest, inten, _INF)]),
        none)
    color_update = torch.isfinite(v_c) & (init_path | kalman_path
                                          | overwrite_path)
    # the +inf of cells without a colored point never reaches the int cast
    best_color = torch.where(color_update, ms4[0], 0.0).to(torch.int32)
    return _replace(state, new_elev, new_var, color_update, best_color,
                    ms4[1])
