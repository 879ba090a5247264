"""Wrap-around index math for the rolling circular-buffer grid.

Counterpart of gem_tpu/core/index_math.py (geographic vs storage indices,
s = (g + start) mod L).  C semantics, as in the reference:

  * float->int casts truncate toward zero; `Tensor.to(torch.int32)` does.
  * x / resolution is x * f32_recip(resolution), XLA's rounding
    (utils/precision.py): it decides the cell a point bins into.
  * C `round()` rounds half away from zero; `torch.round` rounds half to
    even, so `round_half_away` is written out.
  * index wrap is floor-mod: `torch.remainder`, never `torch.fmod`.
"""

from __future__ import annotations

import torch

from gem_tpu_torch.utils.precision import f32_recip


def round_half_away(x):
    """C round(): round-half-away-from-zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def wrap(i, length: int):
    """Wrap any (possibly negative) index into [0, length)."""
    return torch.remainder(i, length)


def index_shift_from_position_shift(position_shift, resolution: float):
    """Window shift in cells from a metric shift (round-half-away through a
    truncating cast, gpu_process.cu:893-902)."""
    v = position_shift * f32_recip(resolution) \
        + 0.5 * torch.sign(position_shift)
    return v.to(torch.int32)


def position_shift_from_index_shift(index_shift, resolution: float):
    return index_shift.to(torch.float32) * resolution


def align_position(center, aligned_shift, resolution: float):
    """Snap center + shift onto the grid lattice (PositionToRange)."""
    inv = f32_recip(resolution)
    p_index = round_half_away(center * inv)
    s_index = round_half_away(aligned_shift * inv)
    return (p_index + s_index) * resolution


def position_to_geo_index(px, py, center, length: int, resolution: float):
    """World position -> geographic cell index (gx, gy) + validity.

    Even L truncates L/2 - shift/res toward zero; odd L rounds shift/res
    half away from zero (PointsToIndex, gpu_process.cu:309-330)."""
    inv = f32_recip(resolution)
    shift_x = px - center[0]
    shift_y = py - center[1]
    if length % 2 == 0:
        half = float(length // 2)
        gx = (half - shift_x * inv).to(torch.int32)
        gy = (half - shift_y * inv).to(torch.int32)
    else:
        gx = length // 2 - (shift_x * inv
                            + 0.5 * torch.sign(shift_x)).to(torch.int32)
        gy = length // 2 - (shift_y * inv
                            + 0.5 * torch.sign(shift_y)).to(torch.int32)
    valid = (gx >= 0) & (gx < length) & (gy >= 0) & (gy < length)
    return gx, gy, valid


def geo_to_storage(gx, gy, start, length: int):
    return torch.remainder(gx + start[0], length), \
        torch.remainder(gy + start[1], length)


def storage_to_geo(sx, sy, start, length: int):
    return torch.remainder(sx - start[0] + length, length), \
        torch.remainder(sy - start[1] + length, length)


def geo_index_to_position(gx, gy, center, length: int, resolution: float):
    """Cell-center world position of a geographic index."""
    off = float(length // 2) - 0.5 if length % 2 == 0 else float(length // 2)
    px = center[0] + (off - gx.to(torch.float32)) * resolution
    py = center[1] + (off - gy.to(torch.float32)) * resolution
    return px, py


def band_mask(index, start, count, length: int):
    """Boolean mask over [0, length): wrap-aware band [start, start+count)."""
    start = wrap(start, length)
    end = start + count
    no_wrap = (index >= start) & (index < end)
    wrapped = (index >= start) | (index < end - length)
    return torch.where(end <= length, no_wrap, wrapped) & (count > 0)


def shift_clear_band(start_indice_i, index_shift_i, length: int):
    """Storage band (start, count) vacated by a window shift along one axis
    (Move's band computation, gpu_process.cu:1041-1067)."""
    n = index_shift_i
    sign = torch.sign(n)
    start_index = start_indice_i - (sign > 0).to(n.dtype)
    end_index = start_index + sign - n
    ncells = torch.abs(n)
    first = wrap(torch.where(sign < 0, start_index, end_index), length)
    count = torch.clamp(ncells, max=length)
    return first, count


def roll_to_geo(plane, start):
    """Storage-indexed (L, L, ...) plane -> geographic layout:
    out[g] = plane[(g + start) mod L].  The counterpart of
    `jnp.roll(plane, -start)`, written as a gather by device indices so the
    shift never has to be read to the host."""
    L = plane.shape[0]
    ar = torch.arange(L, device=plane.device)
    rows = torch.remainder(ar + start[0], L)
    cols = torch.remainder(ar + start[1], L)
    return plane.index_select(0, rows).index_select(1, cols)


def roll_to_storage(plane, start):
    """Geographic (L, L) plane -> storage layout (`jnp.roll(plane, start)`)."""
    L = plane.shape[0]
    ar = torch.arange(L, device=plane.device)
    rows = torch.remainder(ar - start[0], L)
    cols = torch.remainder(ar - start[1], L)
    return plane.index_select(0, rows).index_select(1, cols)
