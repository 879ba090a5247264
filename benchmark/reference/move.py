"""Rolling-buffer relocation ops: move, re-anchor, band shed.

Counterpart of gem_tpu/core/move.py (the reference's `Move`,
`Map_optmove` and the L-shaped submap shed).  Clear semantics follow
G_Clear_map: band clears reset elevation/variance to -10 and
intensity/color to 0 but leave `traver` and `lowest` untouched; only a
full-map clear (shift >= L) resets traver as well.

Every function takes a state with or without a leading robot axis: planes
(..., L, L), `start`/`center` (..., 2), positions (..., 3), and the shed
record, the band index and mask, `full_clear` and `overflow` carry the
same leading dims (JAX's `vmap` of these functions).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import index_math as im
from benchmark.reference.state import MapState
from benchmark.reference.tree import lead


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


def empty_shed(cfg, device, lead=()) -> ShedCells:
    """All-invalid shed record of the fixed band size, with leading dims
    `lead` (`cfg` is a PipelineConfig)."""
    n = 2 * cfg.map.max_shift_cells * cfg.map.length
    lead = tuple(lead)
    z = lambda: torch.zeros(lead + (n,), dtype=torch.float32, device=device)
    return ShedCells(x=z(), y=z(), z=z(), variance=z(),
                     color=torch.zeros(lead + (n,), dtype=torch.int32,
                                       device=device),
                     intensity=z(), traver=z(),
                     valid=torch.zeros(lead + (n,), dtype=torch.bool,
                                       device=device),
                     dropped=torch.zeros(lead, dtype=torch.int32,
                                         device=device))


def _extract_band(state: MapState, cfg, first, count, axis: int,
                  exclude_rows_mask=None):
    """Gather the vacated band along `axis` as flat shed fields, using the
    pre-move start/center (the cells belong to the old window).  `first`
    and `count` are (...,), one band per robot."""
    L = cfg.length
    m = cfg.max_shift_cells
    dev = state.elevation.device
    ar_m = torch.arange(m, device=dev, dtype=torch.int32)
    ar_l = torch.arange(L, device=dev, dtype=torch.int32)
    band = im.wrap(first[..., None] + ar_m, L)            # (..., m) storage
    in_band = ar_m < count[..., None]
    lead = band.shape[:-1]
    bidx = band.long()

    take = lambda p: im.take_along(p, bidx, -2 if axis == 0 else -1)
    if axis == 0:
        sx = band[..., :, None].expand(lead + (m, L))
        sy = ar_l[None, :].expand(lead + (m, L))
        valid = in_band[..., :, None].expand(lead + (m, L))
    else:
        sx = ar_l[:, None].expand(lead + (L, m))
        sy = band[..., None, :].expand(lead + (L, m))
        valid = in_band[..., None, :].expand(lead + (L, m))
        if exclude_rows_mask is not None:
            valid = valid & ~exclude_rows_mask[..., :, None]

    start = state.start[..., None, None, :]
    gx, gy = im.storage_to_geo(sx, sy, start, L)
    px, py = im.geo_index_to_position(gx, gy, state.center[..., None, None, :],
                                      L, cfg.resolution)
    elev = take(state.elevation)
    # shed only populated, traversability-classified cells
    # (src/ElevationMapping.cpp:725)
    valid = valid & (elev != cfg.invalid_elevation) \
        & (take(state.traver) >= 0.0)
    flat = lambda a: a.flatten(-2)
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
    pos_shift = position[..., :2] - state.center
    idx_shift = im.index_shift_from_position_shift(pos_shift, cfg.resolution)
    aligned = im.position_shift_from_index_shift(idx_shift, cfg.resolution)

    big = torch.abs(idx_shift) >= L
    full_clear = big.any(-1)
    first0, count0 = im.shift_clear_band(state.start[..., 0],
                                         idx_shift[..., 0], L)
    first1, count1 = im.shift_clear_band(state.start[..., 1],
                                         idx_shift[..., 1], L)
    # a |shift| >= L falls back to the full clear; band machinery sees 0
    count0 = torch.where(big[..., 0], 0, count0)
    count1 = torch.where(big[..., 1], 0, count1)

    rows = torch.arange(L, device=position.device, dtype=torch.int32)
    row_band = im.band_mask(rows, first0[..., None], count0[..., None], L)
    col_band = im.band_mask(rows, first1[..., None], count1[..., None], L)

    m = cfg.max_shift_cells
    shed_rows = _extract_band(state, cfg, first0,
                              torch.clamp(count0, max=m), 0)
    shed_cols = _extract_band(state, cfg, first1,
                              torch.clamp(count1, max=m), 1,
                              exclude_rows_mask=row_band)
    cat = lambda k: torch.cat([shed_rows[k], shed_cols[k]], dim=-1)
    overflow = (torch.clamp(count0 - m, min=0)
                + torch.clamp(count1 - m, min=0)) * L
    shed = ShedCells(
        x=cat("x"), y=cat("y"), z=cat("z"), variance=cat("variance"),
        color=cat("color").to(torch.int32), intensity=cat("intensity"),
        traver=cat("traver"), valid=cat("valid") & ~full_clear[..., None],
        dropped=overflow.to(torch.int32))

    full = full_clear[..., None, None]
    clear = row_band[..., :, None] | col_band[..., None, :] | full
    new_state = state.replace(
        elevation=torch.where(clear, cfg.invalid_elevation, state.elevation),
        variance=torch.where(clear, cfg.invalid_variance, state.variance),
        intensity=torch.where(clear, 0.0, state.intensity),
        color=torch.where(clear, 0, state.color),
        traver=torch.where(full, cfg.invalid_traversability, state.traver),
        start=im.wrap(state.start - idx_shift, L),
        center=im.align_position(state.center, aligned, cfg.resolution),
        sensor_z=position[..., 2].clone(),
    )
    return new_state, MoveInfo(position_shift=aligned, index_shift=idx_shift,
                               shed=shed)


def re_anchor(state: MapState, cfg, opt_position, height_update) -> MapState:
    """Loop-closure / odometry-jump re-anchor (Map_optmove +
    G_update_mapheight): snap the window center to the optimized pose and
    add a constant height offset to every populated cell.  No band clears."""
    opt_position = opt_position.to(torch.float32)
    shift = opt_position[..., :2] - state.center
    idx_shift = im.index_shift_from_position_shift(shift, cfg.resolution)
    new_center = state.center + idx_shift.to(torch.float32) * cfg.resolution
    valid = state.elevation != cfg.invalid_elevation
    if isinstance(height_update, torch.Tensor):   # () or one per robot
        height_update = lead(height_update, state.elevation)
    return state.replace(
        elevation=torch.where(valid, state.elevation + height_update,
                              state.elevation),
        center=new_center)
