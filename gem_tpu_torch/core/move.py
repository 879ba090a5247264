"""Rolling-buffer relocation ops: move, re-anchor, band shed.

Counterpart of gem_tpu/core/move.py (the reference's `Move`,
`Map_optmove` and the L-shaped submap shed).  Clear semantics follow
G_Clear_map: band clears reset elevation/variance to -10 and
intensity/color to 0 but leave `traver` and `lowest` untouched; only a
full-map clear (shift >= L) resets traver as well.
"""

from __future__ import annotations

import dataclasses

import torch

from gem_tpu_torch.core import index_math as im
from gem_tpu_torch.core.state import MapState


@dataclasses.dataclass(frozen=True)
class ShedCells:
    """Cells evicted from the rolling window this frame, as a fixed-capacity
    point record (capacity = 2 * max_shift_cells * L)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor          # elevation
    variance: torch.Tensor
    color: torch.Tensor      # packed rgb, int32
    intensity: torch.Tensor
    traver: torch.Tensor
    valid: torch.Tensor      # bool
    dropped: torch.Tensor    # int32: cells vacated beyond shed capacity


@dataclasses.dataclass(frozen=True)
class MoveInfo:
    position_shift: torch.Tensor  # (2,) metric shift applied (aligned)
    index_shift: torch.Tensor     # (2,) cells shifted
    shed: ShedCells


def empty_shed(cfg, device) -> ShedCells:
    """All-invalid shed record of the fixed band size (`cfg` is a
    PipelineConfig)."""
    n = 2 * cfg.map.max_shift_cells * cfg.map.length
    z = lambda: torch.zeros((n,), dtype=torch.float32, device=device)
    return ShedCells(x=z(), y=z(), z=z(), variance=z(),
                     color=torch.zeros((n,), dtype=torch.int32,
                                       device=device),
                     intensity=z(), traver=z(),
                     valid=torch.zeros((n,), dtype=torch.bool, device=device),
                     dropped=torch.zeros((), dtype=torch.int32,
                                         device=device))


def _extract_band(state: MapState, cfg, first, count, axis: int,
                  exclude_rows_mask=None):
    """Gather the vacated band along `axis` as flat shed fields, using the
    pre-move start/center (the cells belong to the old window)."""
    L = cfg.length
    m = cfg.max_shift_cells
    dev = state.elevation.device
    ar_m = torch.arange(m, device=dev, dtype=torch.int32)
    ar_l = torch.arange(L, device=dev, dtype=torch.int32)
    band = im.wrap(first + ar_m, L)                       # (m,) storage
    in_band = ar_m < count
    bidx = band.long()

    if axis == 0:
        sx = band[:, None].expand(m, L)
        sy = ar_l[None, :].expand(m, L)
        take = lambda p: p.index_select(0, bidx)
        valid = in_band[:, None].expand(m, L)
    else:
        sx = ar_l[:, None].expand(L, m)
        sy = band[None, :].expand(L, m)
        take = lambda p: p.index_select(1, bidx)
        valid = in_band[None, :].expand(L, m)
        if exclude_rows_mask is not None:
            valid = valid & ~exclude_rows_mask[:, None]

    gx, gy = im.storage_to_geo(sx, sy, state.start, L)
    px, py = im.geo_index_to_position(gx, gy, state.center, L,
                                      cfg.resolution)
    elev = take(state.elevation)
    # shed only populated, traversability-classified cells
    # (src/ElevationMapping.cpp:725)
    valid = valid & (elev != cfg.invalid_elevation) \
        & (take(state.traver) >= 0.0)
    flat = lambda a: a.reshape(-1)
    return dict(x=flat(px), y=flat(py), z=flat(elev),
                variance=flat(take(state.variance)),
                color=flat(take(state.color)),
                intensity=flat(take(state.intensity)),
                traver=flat(take(state.traver)), valid=flat(valid))


def move(state: MapState, cfg, position) -> tuple[MapState, MoveInfo]:
    """Relocate the window so `position` (x, y, z) is its center: shed and
    clear the vacated bands, rotate `start`, snap `center`, record the
    sensor height (`cfg` is a MapConfig)."""
    L = cfg.length
    position = position.to(torch.float32)
    pos_shift = position[:2] - state.center
    idx_shift = im.index_shift_from_position_shift(pos_shift, cfg.resolution)
    aligned = im.position_shift_from_index_shift(idx_shift, cfg.resolution)

    big = torch.abs(idx_shift) >= L
    full_clear = big.any()
    first0, count0 = im.shift_clear_band(state.start[0], idx_shift[0], L)
    first1, count1 = im.shift_clear_band(state.start[1], idx_shift[1], L)
    # a |shift| >= L falls back to the full clear; band machinery sees 0
    count0 = torch.where(big[0], 0, count0)
    count1 = torch.where(big[1], 0, count1)

    rows = torch.arange(L, device=position.device, dtype=torch.int32)
    row_band = im.band_mask(rows, first0, count0, L)
    col_band = im.band_mask(rows, first1, count1, L)

    m = cfg.max_shift_cells
    shed_rows = _extract_band(state, cfg, first0,
                              torch.clamp(count0, max=m), 0)
    shed_cols = _extract_band(state, cfg, first1,
                              torch.clamp(count1, max=m), 1,
                              exclude_rows_mask=row_band)
    cat = lambda k: torch.cat([shed_rows[k], shed_cols[k]])
    overflow = (torch.clamp(count0 - m, min=0)
                + torch.clamp(count1 - m, min=0)) * L
    shed = ShedCells(
        x=cat("x"), y=cat("y"), z=cat("z"), variance=cat("variance"),
        color=cat("color").to(torch.int32), intensity=cat("intensity"),
        traver=cat("traver"), valid=cat("valid") & ~full_clear,
        dropped=overflow.to(torch.int32))

    clear = row_band[:, None] | col_band[None, :] | full_clear
    new_state = state.replace(
        elevation=torch.where(clear, cfg.invalid_elevation, state.elevation),
        variance=torch.where(clear, cfg.invalid_variance, state.variance),
        intensity=torch.where(clear, 0.0, state.intensity),
        color=torch.where(clear, 0, state.color),
        traver=torch.where(full_clear, cfg.invalid_traversability,
                           state.traver),
        start=im.wrap(state.start - idx_shift, L),
        center=im.align_position(state.center, aligned, cfg.resolution),
        sensor_z=position[2].clone(),
    )
    return new_state, MoveInfo(position_shift=aligned, index_shift=idx_shift,
                               shed=shed)


def re_anchor(state: MapState, cfg, opt_position, height_update) -> MapState:
    """Loop-closure / odometry-jump re-anchor (Map_optmove +
    G_update_mapheight): snap the window center to the optimized pose and
    add a constant height offset to every populated cell.  No band clears."""
    opt_position = opt_position.to(torch.float32)
    shift = opt_position[:2] - state.center
    idx_shift = im.index_shift_from_position_shift(shift, cfg.resolution)
    new_center = state.center + idx_shift.to(torch.float32) * cfg.resolution
    valid = state.elevation != cfg.invalid_elevation
    return state.replace(
        elevation=torch.where(valid, state.elevation + height_update,
                              state.elevation),
        center=new_center)
