"""Visibility cleanup: delete obstacles the sensor has seen through.

Counterpart of gem_tpu/kernels/raytrace.py (G_Raytracing rebuild) as plain
tensor code: it is no Pallas kernel in the reference either.  For a
constraining cell c at radial distance d_c beyond an obstacle o at d_o, the
sight line gives bound(o, c) = sensor_z + (lowest(c) - sensor_z) * d_o/d_c,
so the per-direction suffix minimum of g(c) = (lowest(c) - sensor_z) / d_c
decides deletion.

The static tables (`_tables`, `_near_tables`) are the JAX module's NumPy
code, unchanged, so both packages partition the map identically.  Each
`lax.sort` by a constant key there is a fixed permutation, written here as
an `index_select` by the precomputed order; the reversed `lax.cummin` is
flip -> `torch.cummin` -> flip.

Robot axis: a state with planes (R, L, L) and per-robot `start` and
`sensor_z`; the static tables index the last dims and the suffix minima
run along each robot's own rays.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from benchmark.reference.index_math import roll_to_storage
from benchmark.reference.state import MapState
from benchmark.reference.device import upload
from benchmark.reference.precision import f32_recip


def _robot_geo(length: int) -> float:
    # gpu_process.cu:731-742: window-center geographic coordinate
    return length / 2 - 0.5 if length % 2 == 0 else float(length // 2)


@functools.lru_cache(maxsize=8)
def _tables(L: int, R: int, G: int):
    """Static ray-major layout: distances, the slot permutation key (sort 1)
    and its inverse (sort 2), group geometry."""
    robot = _robot_geo(L)
    gx, gy = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    dx = (gx - robot).astype(np.float64)
    dy = (gy - robot).astype(np.float64)
    d = np.hypot(dx, dy).astype(np.float32)                    # (L, L)
    adx = np.abs(dx)
    ady = np.abs(dy)
    sx = np.where(adx > 0, dx, 1.0)
    sy = np.where(ady > 0, dy, 1.0)
    u = np.where(adx >= ady,
                 np.where(dx >= 0, dy / sx, 4.0 + dy / sx),
                 np.where(dy >= 0, 2.0 - dx / sy, 6.0 - dx / sy))
    ray = np.floor((u + 1.0) * (R / 8.0)).astype(np.int64).reshape(-1) % R
    flat_d = d.reshape(-1)

    counts = np.bincount(ray, minlength=R)
    cap = int(np.ceil(max(1.12 * (L * L) / R, counts.max() / 8, G) / G) * G)
    if counts.max() > cap:
        by_d = np.argsort(flat_d, kind="stable")     # global far-last order
        for _ in range(4 * R):
            fat = int(np.argmax(np.bincount(ray, minlength=R)))
            cnt = int(np.sum(ray == fat))
            if cnt <= cap:
                break
            members = by_d[ray[by_d] == fat]
            ray[members[cap:]] = (fat + 1) % R
        counts = np.bincount(ray, minlength=R)
        cap = int(np.ceil(max(counts.max(), 1) / G) * G)

    order = np.lexsort((flat_d, ray))           # by ray, then distance
    nslots = R * cap
    starts = np.cumsum(counts) - counts
    pos_in_ray = np.arange(L * L) - np.repeat(starts, counts)
    slot_sorted = ray[order] * cap + pos_in_ray
    slot_of_cell = np.empty(L * L, np.int64)
    slot_of_cell[order] = slot_sorted

    used = np.zeros(nslots, bool)
    used[slot_sorted] = True
    pad_slots = np.nonzero(~used)[0]
    key1 = np.concatenate([slot_of_cell, pad_slots]).astype(np.int32)

    cell_of_slot = np.full(nslots, -1, np.int64)
    cell_of_slot[slot_of_cell] = np.arange(L * L)
    key2 = np.where(cell_of_slot >= 0, cell_of_slot,
                    L * L + np.arange(nslots)).astype(np.int32)
    return d, key1, key2, cap, nslots


@functools.lru_cache(maxsize=8)
def _near_tables(L: int, R: int, cap: float = 192.0):
    """Near-field polar resample tables.  Returns (R_n, S0, sample_idx,
    sample_in, block, cell_ray, cell_k, cell_d)."""
    robot = _robot_geo(L)
    max_d = (L - 1 - robot) * math.sqrt(2.0) + 1.0
    D0 = min(0.175 * R, cap, max_d)
    S0 = max(int(math.ceil(D0)), 2)
    R_n = min(int(np.ceil(2 * math.pi * S0 / 128.0)) * 128, R)

    theta = np.arange(R_n) * (2.0 * math.pi / R_n)
    ks = np.arange(1, S0 + 1, dtype=np.float64)
    gx = np.round(robot + np.cos(theta)[:, None] * ks[None, :]).astype(int)
    gy = np.round(robot + np.sin(theta)[:, None] * ks[None, :]).astype(int)
    inside = (gx >= 0) & (gx < L) & (gy >= 0) & (gy < L)

    lo = max(int(math.floor(robot - D0)), 0)
    hi = min(int(math.ceil(robot + D0)) + 1, L)
    bw = hi - lo
    bgx = np.clip(gx, lo, hi - 1) - lo
    bgy = np.clip(gy, lo, hi - 1) - lo
    idx = (bgx * bw + bgy).astype(np.int32)
    bx, by = np.meshgrid(np.arange(lo, hi), np.arange(lo, hi), indexing="ij")
    bdx = bx - robot
    bdy = by - robot
    bd = np.hypot(bdx, bdy).astype(np.float32)
    bray = np.round(np.arctan2(bdy, bdx) * (R_n / (2.0 * math.pi)))
    bray = bray.astype(np.int64) % R_n
    bk = np.clip(np.floor(bd).astype(np.int64), 0, S0 - 1)
    return (R_n, S0, idx, inside, (lo, hi),
            bray.astype(np.int32), bk.astype(np.int32), bd)


@functools.lru_cache(maxsize=16)
def _device_tables(L: int, R: int, G: int, device: str):
    """The far-field permutations as device index tensors: the sort by
    key1 is a gather by argsort(key1); the sort by key2, cut to the first
    L*L entries, is a gather by each cell's slot.  Also the distances and
    1/max(d, 1e-6), the reciprocal XLA folds for the division by d."""
    d, key1, key2, cap, nslots = _tables(L, R, G)
    to_slots = upload(np.argsort(key1, kind="stable"), device)
    to_cells = upload(np.argsort(key2, kind="stable")[:L * L], device)
    inv_d = f32_recip(np.maximum(d, np.float32(1e-6)))
    return (upload(d, device), upload(inv_d, device), to_slots, to_cells,
            cap, nslots)


@functools.lru_cache(maxsize=16)
def _device_near_tables(L: int, R: int, cap: float, device: str):
    R_n, S0, idx, inside, block, bray, bk, _ = _near_tables(L, R, cap)
    sample = upload(idx.reshape(-1).astype(np.int64), device)
    cell = upload((bray.astype(np.int64) * S0 + bk).reshape(-1), device)
    return (R_n, S0, sample, upload(inside, device), block, cell,
            bray.shape)


def _suffix_min_beyond(x):
    """Along the last dim, min over strictly later entries (+inf at the
    last): the reversed exclusive cummin."""
    suffix = torch.flip(torch.cummin(torch.flip(x, dims=(-1,)),
                                     dim=-1).values, dims=(-1,))
    return torch.cat([suffix[..., 1:], torch.full_like(suffix[..., :1],
                                                       float("inf"))],
                     dim=-1)


def _far_min_g(g, L: int, R: int, G: int):
    """Slot-space far-field pipeline on a (..., L, L) geographic
    constraint field: to ray-major slots, per-group min + exclusive suffix
    over strictly-farther groups, back to cell order."""
    _, _, to_slots, to_cells, cap, nslots = _device_tables(
        L, R, G, str(g.device))
    lead = g.shape[:-2]
    vals1 = torch.cat([g.flatten(-2),
                       torch.full(lead + (nslots - L * L,), float("inf"),
                                  device=g.device)], dim=-1)
    g_slots = vals1.index_select(-1, to_slots)
    nb = cap // G
    bins = g_slots.reshape(lead + (R, nb, G)).amin(dim=-1)     # (R, nb)
    beyond = _suffix_min_beyond(bins)
    slot_beyond = beyond[..., None].expand(lead + (R, nb, G)).reshape(
        lead + (-1,))
    return slot_beyond.index_select(-1, to_cells).reshape(lead + (L, L))


def _far_pool(cfg) -> int:
    """Far-field min-pool factor: explicit, or auto (3 at L >= 768, 2 at
    L >= 512, else 1), as in the JAX module."""
    p = cfg.raytrace_far_pool
    if p > 0:
        return p
    if cfg.length >= 768:
        return 3
    return 2 if cfg.length >= 512 else 1


def raytrace_cleanup(state: MapState, cfg, traver) -> MapState:
    """Returns state with occluding stale obstacles deleted and the lowest
    plane reset (`cfg` is a MapConfig)."""
    L = cfg.length
    R = cfg.num_rays()
    G = cfg.raytrace_group if cfg.raytrace_group > 0 else max(2, L // 250)
    dev = state.elevation.device
    lead = state.elevation.shape[:-2]
    d, inv_d, _, _, _, _ = _device_tables(L, R, G, str(dev))
    inf = float("inf")
    sensor_z = state.sensor_z[..., None, None]

    # --- constraint field g per geographic cell ---------------------------
    low = state.lowest
    seen = (low != cfg.lowest_reset) & (low != cfg.lowest_init) & (d > 0.0)
    g = torch.where(seen, (low - sensor_z) * inv_d, inf)

    # --- far field: suffix-min over the ray partition (p x p min-pool) -----
    p = _far_pool(cfg)
    if p == 1:
        min_g = _far_min_g(g, L, R, G)
    else:
        Lp = -(-L // p)
        pad = Lp * p - L
        g_pad = torch.nn.functional.pad(g, (0, pad, 0, pad), value=inf)
        g_p = g_pad.reshape(lead + (Lp, p, Lp, p)).amin(dim=(-3, -1))
        Gp = cfg.raytrace_group if cfg.raytrace_group > 0 \
            else max(2, Lp // 250)
        min_g_p = _far_min_g(g_p, Lp, R, Gp)
        min_g = min_g_p.repeat_interleave(p, dim=-2).repeat_interleave(
            p, dim=-1)[..., :L, :L]

    # --- near-field cone (resample formulation, static gathers) -----------
    R_n, S0, n_idx, n_in, (blo, bhi), n_cell, bshape = _device_near_tables(
        L, R, 192.0 if p == 1 else 96.0, str(dev))
    low_blk = low[..., blo:bhi, blo:bhi].flatten(-2)
    low_n = low_blk.index_select(-1, n_idx).reshape(lead + (R_n, S0))
    seen_n = n_in & (low_n != cfg.lowest_reset) & (low_n != cfg.lowest_init)
    ks = torch.arange(1, S0 + 1, dtype=torch.float32, device=dev)
    g_n = torch.where(seen_n, (low_n - sensor_z) / ks, inf)
    beyond_n = _suffix_min_beyond(g_n)
    near_vals = beyond_n.flatten(-2).index_select(-1, n_cell).reshape(
        lead + bshape)
    min_g = min_g.clone()
    min_g[..., blo:bhi, blo:bhi] = torch.minimum(
        min_g[..., blo:bhi, blo:bhi], near_vals)

    # --- deletion test in storage space -----------------------------------
    min_g_s = roll_to_storage(min_g, state.start)
    d_s = roll_to_storage(d.expand(lead + (L, L)), state.start)
    bound = sensor_z + d_s * min_g_s
    obstacle = (traver < cfg.obstacle_threshold) \
        & (state.elevation != cfg.invalid_elevation) & (d_s > 0.0)
    delete = obstacle & torch.isfinite(min_g_s) & (
        state.elevation - 3.0 * torch.sqrt(torch.clamp(state.variance,
                                                       min=0.0))
        > bound)
    return state.replace(
        elevation=torch.where(delete, cfg.invalid_elevation,
                              state.elevation),
        lowest=torch.full(lead + (L, L), cfg.lowest_reset,
                          dtype=torch.float32, device=dev))
