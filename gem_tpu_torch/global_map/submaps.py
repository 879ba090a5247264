"""Odometry-keyed submap store as fixed-capacity ring tensors.

Counterpart of gem_tpu/global_map/submaps.py: a ring of K submap slots, each
a fixed-(capacity,) struct of arrays plus a count, a live accumulator, and a
staging ring that defers the shed compaction (SubmapConfig.staging_frames).
Appends are kernels/compact.py's `compact_append` (a cumsum and a gather
per field on the CPU, K5 on a card); points past the capacity are counted
as dropped, so no append reads a count to the host.

In place: the large rings, `staging`, `slots` and `orthos`, are updated in
place (one band copy per frame, one slot copy per finalize) instead of being
rebuilt, which would copy ~60 MB each per frame at the flagship size.  The
store passed to `append_shed`, `flush_staging` and `finalize_submap` is
consumed; use the returned one.

No host read: the staging row is a device index, and the staging flush is
`utils.control.when(used >= S, flush_staging, store)`, the counterpart of
JAX's `lax.cond`.  `flush_staging` and `finalize_submap` are `when`
bodies (utils/control.py): they write every leaf they change into the
store's own tensors and return the same store, where their () or (R,)
bool `when` is True, or everywhere for `when` None (the branch is
taken).  Every ring write goes through one slot write, which rewrites a
slot with its own rows where `when` is False; every counter and the
accumulator through `control.assign` / `control.clear`.  So the branch
can be the body of a CUDA-graph IF node, after which nothing reads a
tensor made inside it, and the select route (a fleet, or the eager call
on a card) runs the same body under a mask.
"""

from __future__ import annotations

import dataclasses

import torch

from gem_tpu_torch.core import index_math as im
from gem_tpu_torch.core.move import ShedCells
from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels.compact import compact_append as _compact_append
from gem_tpu_torch.utils.control import (assign, clear, select,
                                         when as branch_when)
from gem_tpu_torch.utils.observability import TRACER
from gem_tpu_torch.utils.tree import flat_rows

_FIELDS = ("x", "y", "z", "variance", "intensity", "traver", "color",
           "valid")


@dataclasses.dataclass(frozen=True)
class PointBuffer:
    """Fixed-capacity struct-of-arrays point set (leading dims arbitrary)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    variance: torch.Tensor
    intensity: torch.Tensor
    traver: torch.Tensor
    color: torch.Tensor     # int32 packed
    valid: torch.Tensor     # bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def empty_buffer(shape, device) -> PointBuffer:
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return PointBuffer(x=z(), y=z(), z=z(), variance=z(), intensity=z(),
                       traver=z(),
                       color=torch.zeros(shape, dtype=torch.int32,
                                         device=device),
                       valid=torch.zeros(shape, dtype=torch.bool,
                                         device=device))


@dataclasses.dataclass(frozen=True)
class SubmapStore:
    """Ring of K submap slots + the live accumulator for the current one."""

    slots: PointBuffer            # (K, capacity)
    counts: torch.Tensor          # (K,) int32
    centers: torch.Tensor         # (K, 2) keyframe xy
    poses: torch.Tensor           # (K, 7) keyframe pose [xyz, quat wxyz]
    num_submaps: torch.Tensor     # () int32 total finalized
    kf_ids: torch.Tensor          # (K,) int32 global keyframe id (-1 empty)
    accum: PointBuffer            # (capacity,) current-submap accumulator
    accum_count: torch.Tensor     # () int32
    dropped: torch.Tensor         # () int32 points lost to capacity
    staging: PointBuffer          # (S, band) deferred shed bands
    staging_used: torch.Tensor    # () int32 staged frames
    orthos: torch.Tensor          # (K, L, L, 3) uint8, or (K, 0, 0, 3) off
    kf_points: torch.Tensor       # (K, M, 3) raw keyframe scan
    kf_counts: torch.Tensor       # (K,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_store(cfg, device) -> SubmapStore:
    K, C = cfg.submap.max_submaps, cfg.submap.capacity
    Lo = cfg.map.length if cfg.submap.store_ortho else 0
    M = cfg.submap.keyframe_scan_points
    band = 2 * cfg.map.max_shift_cells * cfg.map.length  # == ShedCells size
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    poses = torch.zeros((K, 7), **f32)
    poses[:, 3] = 1.0
    return SubmapStore(
        slots=empty_buffer((K, C), device),
        counts=torch.zeros((K,), **i32),
        centers=torch.zeros((K, 2), **f32),
        poses=poses,
        num_submaps=torch.zeros((), **i32),
        kf_ids=torch.full((K,), -1, **i32),
        accum=empty_buffer((C,), device),
        accum_count=torch.zeros((), **i32),
        dropped=torch.zeros((), **i32),
        staging=empty_buffer((cfg.submap.staging_frames, band), device),
        staging_used=torch.zeros((), **i32),
        orthos=torch.zeros((K, Lo, Lo, 3), dtype=torch.uint8,
                           device=device),
        kf_points=torch.zeros((K, M, 3), **f32),
        kf_counts=torch.zeros((K,), **i32),
    )


def shed_to_buffer(shed: ShedCells) -> PointBuffer:
    return PointBuffer(x=shed.x, y=shed.y, z=shed.z, variance=shed.variance,
                       intensity=shed.intensity, traver=shed.traver,
                       color=shed.color, valid=shed.valid)


def _ring_rows(slot, K: int):
    """The row of `slot` (...) in a ring (..., K, ...) flattened to (B *
    K, ...): one `index_select` / `index_copy` then serves every robot."""
    return flat_rows(slot.unsqueeze(-1), K).reshape(-1)


def _flat_ring(ring, nb: int):
    return ring.reshape((-1,) + ring.shape[nb + 1:])


def flush_staging(store: SubmapStore, when=None) -> SubmapStore:
    """Compact every staged shed band into the accumulator, in frame order
    (unstaged rows carry valid=False), in place, where the () or (R,) bool
    `when` is True (`when` None: everywhere): the returned store is
    `store`.  Stamps the tracer's `flush` (a finalize's own flush does
    not)."""
    if store.staging.x.shape[-2] > 0:
        TRACER.mark("flush", store.staging.x.device)
    return _flush(store, when)


def _flush(store: SubmapStore, when=None) -> SubmapStore:
    st = store.staging
    if st.x.shape[-2] == 0:
        return store
    flat = PointBuffer(**{f: getattr(st, f).flatten(-2) for f in _FIELDS})
    accum, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                          flat)
    for f in _FIELDS:
        assign(when, getattr(store.accum, f), getattr(accum, f))
    assign(when, store.accum_count, cnt)
    assign(when, store.dropped, store.dropped + dropped)
    clear(when, st.valid)
    clear(when, store.staging_used)
    return store


def append_shed(store: SubmapStore, shed: ShedCells) -> SubmapStore:
    """Accumulate this frame's evicted cells into the current submap.

    With staging on, the band is written into row `staging_used` of the
    ring (a device index, so no count is read to the host) and the ring is
    compacted on the frame it fills, a `control.when` branch.  A shed of
    another width flushes and compacts at once."""
    S = store.staging.x.shape[-2]
    if S == 0 or shed.x.shape[-1] != store.staging.x.shape[-1]:
        store = flush_staging(store)
        accum, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                              shed_to_buffer(shed))
        return store.replace(accum=accum, accum_count=cnt,
                             dropped=store.dropped + dropped + shed.dropped)
    used = store.staging_used
    rows = _ring_rows(used.long(), S)
    for f in _FIELDS:
        flat = _flat_ring(getattr(store.staging, f), used.dim())
        flat.index_copy_(0, rows, getattr(shed, f).reshape(
            (-1,) + flat.shape[1:]))
    used = store.staging_used + 1
    store = store.replace(staging_used=used,
                          dropped=store.dropped + shed.dropped)
    return branch_when(used >= S, flush_staging, store)


def grid_to_points(state: MapState, cfg, traver) -> PointBuffer:
    """Snapshot the live grid as a point set: valid cells with classified
    traversability (gridMaptoPointCloud); (..., L*L) per leading index."""
    L = cfg.map.length
    g = torch.arange(L, device=state.elevation.device, dtype=torch.int32)
    sx = g.repeat_interleave(L)
    sy = g.repeat(L)
    gx, gy = im.storage_to_geo(sx, sy, state.start[..., None, :], L)
    px, py = im.geo_index_to_position(gx, gy, state.center[..., None, :], L,
                                      cfg.map.resolution)
    elev = state.elevation.flatten(-2)
    trav = traver.flatten(-2)
    valid = (elev != cfg.map.invalid_elevation) \
        & (trav != cfg.map.invalid_traversability)
    return PointBuffer(x=px, y=py, z=elev,
                       variance=state.variance.flatten(-2),
                       intensity=state.intensity.flatten(-2), traver=trav,
                       color=state.color.flatten(-2), valid=valid)


def finalize_submap(store: SubmapStore, grid_points: PointBuffer,
                    keyframe_pose, ortho=None, kf_points=None,
                    kf_count=None, when=None) -> SubmapStore:
    """Close the current submap: accumulator + grid snapshot -> next ring
    slot; optional (L, L, 3) orthomosaic `ortho` (written into the
    `orthos` ring) and raw keyframe scan `kf_points` (M, 3) with
    `kf_count` valid rows.  In place, where the () or (R,) bool `when` is
    True (`when` None: everywhere): the returned store is `store`.  With a
    robot axis each robot closes into its own next slot."""
    K = store.counts.shape[-1]
    slot = torch.remainder(store.num_submaps, K).long()
    nb = slot.dim()
    store = _flush(store, when)   # staged bands precede the snapshot
    merged, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                           grid_points)
    rows = _ring_rows(slot, K)

    def write_slot(ring, value):
        flat = _flat_ring(ring, nb)
        if when is not None:
            old = flat.index_select(0, rows)
            value = select(when, value.reshape(old.shape), old)
        flat.index_copy_(0, rows, value.reshape((-1,) + flat.shape[1:]))

    for f in _FIELDS:
        write_slot(getattr(store.slots, f), getattr(merged, f))
    if ortho is not None and store.orthos.shape[nb + 1] > 0:
        write_slot(store.orthos, ortho.to(torch.uint8))
    if kf_points is not None and store.kf_points.shape[nb + 1] > 0:
        write_slot(store.kf_points, kf_points.to(torch.float32))
        write_slot(store.kf_counts, kf_count.to(torch.int32))
    pose = keyframe_pose.to(torch.float32)
    write_slot(store.counts, cnt)
    write_slot(store.centers, pose[..., :2])
    write_slot(store.poses, pose)
    write_slot(store.kf_ids, store.num_submaps)
    assign(when, store.num_submaps, store.num_submaps + 1)
    for f in _FIELDS:
        clear(when, getattr(store.accum, f))
    clear(when, store.accum_count)
    assign(when, store.dropped, store.dropped + dropped)
    return store
