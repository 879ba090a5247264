"""Odometry-keyed submap store as fixed-capacity ring tensors.

Counterpart of gem_tpu/global_map/submaps.py: a ring of K submap slots, each
a fixed-(capacity,) struct of arrays plus a count, a live accumulator, and a
staging ring that defers the shed compaction (SubmapConfig.staging_frames).
Appends are cumsum compaction plus one scatter; targets past the capacity
land in a dump row that is cut off, so no append reads a count to the host.

In place: the large rings, `staging`, `slots` and `orthos`, are updated in
place (one band copy per frame, one slot copy per keyframe) instead of being
rebuilt, which would copy ~60 MB each per frame at the flagship size.  The
store passed to `append_shed`, `flush_staging` and `finalize_submap` is
consumed; use the returned one.
"""

from __future__ import annotations

import dataclasses

import torch

from gem_tpu_torch.core import index_math as im
from gem_tpu_torch.core.move import ShedCells
from gem_tpu_torch.core.state import MapState

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


def _compact_append(buf: PointBuffer, count, new: PointBuffer):
    """Append new.valid points into buf at positions [count, ...),
    compacted: the i-th valid input goes to count + (#valid before i)."""
    C = buf.capacity
    v = new.valid
    pos = count + torch.cumsum(v.to(torch.int32), 0) - 1
    keep = v & (pos < C)
    appended = keep.sum(dtype=torch.int32)
    dropped = v.sum(dtype=torch.int32) - appended
    tgt = torch.where(keep, pos, C).long()           # row C: dump, cut off
    # one stacked scatter; every field is exact in f32 (rgb < 2^24)
    newmat = torch.stack(
        [new.x, new.y, new.z, new.variance, new.intensity, new.traver,
         new.color.to(torch.float32), torch.ones_like(new.x)], dim=1)
    bufmat = torch.stack(
        [buf.x, buf.y, buf.z, buf.variance, buf.intensity, buf.traver,
         buf.color.to(torch.float32), buf.valid.to(torch.float32)], dim=1)
    m = torch.cat([bufmat, bufmat.new_zeros((1, 8))])
    m.index_copy_(0, tgt, newmat)
    m = m[:C]
    out = PointBuffer(x=m[:, 0], y=m[:, 1], z=m[:, 2], variance=m[:, 3],
                      intensity=m[:, 4], traver=m[:, 5],
                      color=m[:, 6].to(torch.int32), valid=m[:, 7] > 0.5)
    return out, count + appended, dropped


def shed_to_buffer(shed: ShedCells) -> PointBuffer:
    return PointBuffer(x=shed.x, y=shed.y, z=shed.z, variance=shed.variance,
                       intensity=shed.intensity, traver=shed.traver,
                       color=shed.color, valid=shed.valid)


def flush_staging(store: SubmapStore) -> SubmapStore:
    """Compact every staged shed band into the accumulator, in frame order
    (unstaged rows carry valid=False)."""
    st = store.staging
    if st.x.shape[0] == 0:
        return store
    flat = PointBuffer(**{f: getattr(st, f).reshape(-1) for f in _FIELDS})
    accum, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                          flat)
    st.valid.zero_()
    return store.replace(accum=accum, accum_count=cnt,
                         dropped=store.dropped + dropped,
                         staging_used=torch.zeros_like(store.staging_used))


def append_shed(store: SubmapStore, shed: ShedCells,
                staged: int | None = None) -> SubmapStore:
    """Accumulate this frame's evicted cells into the current submap.

    With staging on, the band is parked in row `staged` of the ring (the
    host's copy of `store.staging_used`; read from the device when None) and
    the ring is compacted when it fills.  A shed of another width flushes
    and compacts at once."""
    S = store.staging.x.shape[0]
    if S == 0 or shed.x.shape[-1] != store.staging.x.shape[-1]:
        store = flush_staging(store)
        accum, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                              shed_to_buffer(shed))
        return store.replace(accum=accum, accum_count=cnt,
                             dropped=store.dropped + dropped + shed.dropped)
    i = int(store.staging_used) if staged is None else staged
    for f in _FIELDS:
        getattr(store.staging, f)[i].copy_(getattr(shed, f))
    store = store.replace(staging_used=store.staging_used + 1,
                          dropped=store.dropped + shed.dropped)
    return flush_staging(store) if i + 1 >= S else store


def grid_to_points(state: MapState, cfg, traver) -> PointBuffer:
    """Snapshot the live grid as a point set: valid cells with classified
    traversability (gridMaptoPointCloud)."""
    L = cfg.map.length
    g = torch.arange(L, device=state.elevation.device, dtype=torch.int32)
    sx = g.repeat_interleave(L)
    sy = g.repeat(L)
    gx, gy = im.storage_to_geo(sx, sy, state.start, L)
    px, py = im.geo_index_to_position(gx, gy, state.center, L,
                                      cfg.map.resolution)
    elev = state.elevation.reshape(-1)
    trav = traver.reshape(-1)
    valid = (elev != cfg.map.invalid_elevation) \
        & (trav != cfg.map.invalid_traversability)
    return PointBuffer(x=px, y=py, z=elev,
                       variance=state.variance.reshape(-1),
                       intensity=state.intensity.reshape(-1), traver=trav,
                       color=state.color.reshape(-1), valid=valid)


def finalize_submap(store: SubmapStore, grid_points: PointBuffer,
                    keyframe_pose, ortho=None, kf_points=None,
                    kf_count=None) -> SubmapStore:
    """Close the current submap: accumulator + grid snapshot -> next ring
    slot; optional (L, L, 3) orthomosaic `ortho` (written in place into
    the `orthos` ring) and raw keyframe scan `kf_points` (M, 3) with
    `kf_count` valid rows."""
    K = store.counts.shape[0]
    slot = torch.remainder(store.num_submaps, K).reshape(1).long()
    store = flush_staging(store)   # staged bands precede the grid snapshot
    merged, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                           grid_points)
    for f in _FIELDS:
        getattr(store.slots, f).index_copy_(0, slot,
                                            getattr(merged, f)[None])
    if ortho is not None and store.orthos.shape[1] > 0:
        store.orthos.index_copy_(0, slot, ortho.to(torch.uint8)[None])
    pose = keyframe_pose.to(torch.float32)
    put = lambda arr, v: arr.index_copy(0, slot, v[None])
    kf_pts, kf_counts = store.kf_points, store.kf_counts
    if kf_points is not None and store.kf_points.shape[1] > 0:
        kf_pts = put(kf_pts, kf_points.to(torch.float32))
        kf_counts = put(kf_counts, kf_count.to(torch.int32))
    C = store.accum.capacity
    return store.replace(
        counts=put(store.counts, cnt),
        centers=put(store.centers, pose[:2]),
        poses=put(store.poses, pose),
        num_submaps=store.num_submaps + 1,
        kf_ids=put(store.kf_ids, store.num_submaps),
        accum=empty_buffer((C,), pose.device),
        accum_count=torch.zeros_like(store.accum_count),
        dropped=store.dropped + dropped,
        kf_points=kf_pts, kf_counts=kf_counts)
