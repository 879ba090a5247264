"""The least time a kernel could take on the card: its bytes and operations
at the H100's published peaks (NVIDIA's data sheet, SXM part, at its full
700 W power limit), copied from chip_smoke.py (`bound`, `k1_bound`, and
phase 4's K2 count) so that the yardstick does not move with the program.

Bytes count each input read once and each output written once, and only
what these inputs need (for K1: the points that lie in a cell and the
priors of the cells that hold points)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K2's fp32 operations per cell: a fitted cell's 25 x 13 moment terms and
# its ~250-operation eigen epilogue; another cell's 25 validity tests
K2_OPS_FITTED = 575
K2_OPS_COUNT = 25
# the kernels' symbols, as the profiler names their launches
K1_SYMBOL = "fuse_stream_aggregate_kernel"
K2_SYMBOL = "plane_fit_kernel"


def bound(nbytes, ops=0.0):
    """(bound ms, "bytes" or "operations"): the least time to move `nbytes`
    and do `ops` fp32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bytes(n_cells: int, in_cells: int, occupied: int) -> int:
    """K1's least bytes for one robot: its 16 output rows over the n_cells
    cells, the n_cells + 1 run offsets (int64), four float columns of the
    sorted points that lie in a cell, and the two priors of each occupied
    cell."""
    return (16 * n_cells * 4 + (n_cells + 1) * 8 + 4 * in_cells * 4
            + 2 * occupied * 4)


def k1_counts(offsets):
    """(n_cells, points in cells, occupied cells) from the run offsets."""
    n_cells = offsets.shape[-1] - 1
    occupied = int((offsets[..., 1:] > offsets[..., :-1]).sum())
    in_cells = int((offsets[..., -1] - offsets[..., 0]).sum())
    return n_cells, in_cells, occupied


def k1_bound(n_cells: int, in_cells: int, occupied: int):
    return bound(k1_bytes(n_cells, in_cells, occupied))


def k2_bound(cells: int, fitted: int):
    """24 bytes per cell (the elevation read, four float planes and the
    count written) and K2_OPS_FITTED operations per fitted cell,
    K2_OPS_COUNT per other cell."""
    return bound(24 * cells, K2_OPS_FITTED * fitted
                 + K2_OPS_COUNT * (cells - fitted))
