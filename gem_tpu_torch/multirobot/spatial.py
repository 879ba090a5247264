"""Spatial map sharding: one elevation grid split by rows over the ranks of
a process group.

Counterpart of gem_tpu/multirobot/spatial.py.  Elementwise phases need no
communication; the 5x5 plane-fit stencil needs a 2-row halo from each
neighbour, exchanged with `ring_shift` in both directions.  The first and
last rank get invalid-filled halos: the map has no rows beyond them.

The planes are geographic (storage start 0), as in the JAX package: the
rolling window's storage rotation would split geographic neighbours across
ranks.  The moments are the plain version's (`kernels/features.py`
`accumulate_moments`) on the halo-extended block, the rows masked by their
geographic index and the columns shifted by a roll plus a bounds mask
(no wrap-around), and `features_from_moments` turns them into features;
so a sharded plane equals the unsharded one.
"""

from __future__ import annotations

import torch

from gem_tpu_torch.kernels.features import (accumulate_moments,
                                            features_from_moments)
from gem_tpu_torch.multirobot import distributed as mdist

_HALO = 2   # 5x5 stencil


def _features_block(elev_block, row_offset: int, cfg, total_rows: int):
    """(slope, rough, traver) of the (rows, L) interior of a (2 + rows + 2,
    L) block whose first interior row is geographic row `row_offset`."""
    L = elev_block.shape[1]
    rows = elev_block.shape[0] - 2 * _HALO
    dev = elev_block.device
    g_rows = row_offset + torch.arange(rows, device=dev)
    g_cols = torch.arange(L, device=dev)
    acc = accumulate_moments(
        lambda i, j: torch.roll(elev_block[_HALO + i:_HALO + i + rows],
                                shifts=-j, dims=1),
        lambda i: (g_rows + i >= 0) & (g_rows + i < total_rows),
        lambda j: (g_cols + j >= 0) & (g_cols + j < L), (rows, L), dev,
        cfg)
    interior = elev_block[_HALO:_HALO + rows]
    slope, rough, traver, _, _ = features_from_moments(acc, interior, cfg)
    return slope, rough, traver


def sharded_features(cfg, group=None):
    """The feature pass over a row-sharded geographic elevation plane
    (`cfg` is a MapConfig): fn(this rank's (L / n, L) rows) -> (slope,
    rough, traver) of those rows, halos exchanged over `group`."""
    rank, n = mdist.rank_and_size(group)
    L = cfg.length
    if L % n:
        raise ValueError(f"length={L} not divisible by {n} shards")
    rows = L // n

    def body(elev_local):
        # the previous rank's last rows above, the next rank's first below
        top = mdist.ring_shift(elev_local[-_HALO:], group, direction=1)
        bot = mdist.ring_shift(elev_local[:_HALO], group, direction=-1)
        inv = torch.full_like(top, cfg.invalid_elevation)
        top = inv if rank == 0 else top
        bot = inv if rank == n - 1 else bot
        block = torch.cat([top, elev_local, bot])
        return _features_block(block, rank * rows, cfg, L)

    return body


def place_row_sharded(plane, group=None):
    """This rank's rows of a full (L, L) plane, on the rank's device
    (without a process group, the whole plane where it is)."""
    rank, n = mdist.rank_and_size(group)
    rows = plane.shape[0] // n
    return mdist.to_rank_device(plane[rank * rows:(rank + 1) * rows], group)
