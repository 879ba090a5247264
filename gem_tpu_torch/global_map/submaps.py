"""Odometry-keyed submap store as fixed-capacity ring tensors.

Counterpart of gem_tpu/global_map/submaps.py: a ring of K submap slots, each
a fixed-(capacity,) struct of arrays plus a count, a live accumulator, and a
staging ring that defers the shed compaction (SubmapConfig.staging_frames).
Appends are a cumsum over the new points and, per field, one gather of the
capacity's rows; points past the capacity are counted as dropped, so no
append reads a count to the host.

In place: the large rings, `staging`, `slots` and `orthos`, are updated in
place (one band copy per frame, one slot copy per finalize) instead of being
rebuilt, which would copy ~60 MB each per frame at the flagship size.  The
store passed to `append_shed`, `flush_staging` and `finalize_submap` is
consumed; use the returned one.

No host read: the staging row is a device index, and the flush and the
finalize take a () bool `when` instead of a Python branch (the step's
selects for JAX's `lax.cond`).  They then run on every frame and keep the
old values where `when` is False; a ring slot is rewritten with its own
rows.
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
    compacted: the i-th valid input goes to count + (#valid before i);
    inputs past the capacity are dropped and counted.

    Written as a gather: output row j >= count takes the valid input of
    rank j - count, found by `searchsorted` on the running count of valid
    inputs, so the work is (capacity) gathers plus one cumsum whatever the
    input size.  The JAX version scatters every input, the invalid ones to
    a dump row; both place every point alike.  Every output color passes
    through f32 as in JAX's stacked scatter (exact for rgb < 2^24)."""
    C = buf.capacity
    n = new.valid.shape[0]
    if n == 0:
        return buf, count, torch.zeros_like(count)
    ranks = torch.cumsum(new.valid, 0, dtype=torch.int32)   # inclusive
    total = ranks[-1]
    appended = torch.clamp(torch.minimum(total, C - count), min=0)
    rank = torch.arange(C, dtype=torch.int32, device=ranks.device) - count
    take = (rank >= 0) & (rank < appended)
    src = torch.clamp(torch.searchsorted(ranks, rank + 1), max=n - 1)
    pick = lambda f: torch.where(take, getattr(new, f)[src], getattr(buf, f))
    out = PointBuffer(
        x=pick("x"), y=pick("y"), z=pick("z"), variance=pick("variance"),
        intensity=pick("intensity"), traver=pick("traver"),
        color=pick("color").to(torch.float32).to(torch.int32),
        valid=take | buf.valid)
    return out, count + appended, total - appended


def shed_to_buffer(shed: ShedCells) -> PointBuffer:
    return PointBuffer(x=shed.x, y=shed.y, z=shed.z, variance=shed.variance,
                       intensity=shed.intensity, traver=shed.traver,
                       color=shed.color, valid=shed.valid)


def _select(when, new, old):
    """`new` where the branch is taken; `when` None: always."""
    return new if when is None else torch.where(when, new, old)


def _cleared(when, old):
    """Zeros where the branch is taken; `when` None: always."""
    return torch.zeros_like(old) if when is None else old.masked_fill(when, 0)


def flush_staging(store: SubmapStore, when=None) -> SubmapStore:
    """Compact every staged shed band into the accumulator, in frame order
    (unstaged rows carry valid=False).  With a () bool `when`, only where
    it is True: the compaction runs either way and the store keeps its old
    leaves where `when` is False (the select for JAX's `lax.cond`)."""
    st = store.staging
    if st.x.shape[0] == 0:
        return store
    flat = PointBuffer(**{f: getattr(st, f).reshape(-1) for f in _FIELDS})
    accum, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                          flat)
    if when is None:
        st.valid.zero_()
    else:
        st.valid.logical_and_(~when)
    return store.replace(
        accum=PointBuffer(**{f: _select(when, getattr(accum, f),
                                        getattr(store.accum, f))
                             for f in _FIELDS}),
        accum_count=_select(when, cnt, store.accum_count),
        dropped=_select(when, store.dropped + dropped, store.dropped),
        staging_used=_cleared(when, store.staging_used))


def append_shed(store: SubmapStore, shed: ShedCells) -> SubmapStore:
    """Accumulate this frame's evicted cells into the current submap.

    With staging on, the band is written into row `staging_used` of the
    ring (a device index, so no count is read to the host) and the ring is
    compacted on the frame it fills, by a mask.  A shed of another width
    flushes and compacts at once."""
    S = store.staging.x.shape[0]
    if S == 0 or shed.x.shape[-1] != store.staging.x.shape[-1]:
        store = flush_staging(store)
        accum, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                              shed_to_buffer(shed))
        return store.replace(accum=accum, accum_count=cnt,
                             dropped=store.dropped + dropped + shed.dropped)
    row = store.staging_used.reshape(1).long()
    for f in _FIELDS:
        getattr(store.staging, f).index_copy_(0, row, getattr(shed, f)[None])
    used = store.staging_used + 1
    store = store.replace(staging_used=used,
                          dropped=store.dropped + shed.dropped)
    return flush_staging(store, when=used >= S)


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
                    kf_count=None, when=None) -> SubmapStore:
    """Close the current submap: accumulator + grid snapshot -> next ring
    slot; optional (L, L, 3) orthomosaic `ortho` (written in place into
    the `orthos` ring) and raw keyframe scan `kf_points` (M, 3) with
    `kf_count` valid rows.  With a () bool `when`, only where it is True:
    the slot is rewritten with its old rows and every counter stays where
    `when` is False."""
    K = store.counts.shape[0]
    slot = torch.remainder(store.num_submaps, K).reshape(1).long()
    store = flush_staging(store, when)   # staged bands precede the snapshot
    merged, cnt, dropped = _compact_append(store.accum, store.accum_count,
                                           grid_points)

    def write_slot(ring, value):
        ring.index_copy_(0, slot, _select(when, value[None],
                                          ring.index_select(0, slot)))

    for f in _FIELDS:
        write_slot(getattr(store.slots, f), getattr(merged, f))
    if ortho is not None and store.orthos.shape[1] > 0:
        write_slot(store.orthos, ortho.to(torch.uint8))
    pose = keyframe_pose.to(torch.float32)
    put = lambda arr, v: _select(when, arr.index_copy(0, slot, v[None]), arr)
    kf_pts, kf_counts = store.kf_points, store.kf_counts
    if kf_points is not None and store.kf_points.shape[1] > 0:
        kf_pts = put(kf_pts, kf_points.to(torch.float32))
        kf_counts = put(kf_counts, kf_count.to(torch.int32))
    return store.replace(
        counts=put(store.counts, cnt),
        centers=put(store.centers, pose[:2]),
        poses=put(store.poses, pose),
        num_submaps=_select(when, store.num_submaps + 1, store.num_submaps),
        kf_ids=put(store.kf_ids, store.num_submaps),
        accum=PointBuffer(**{f: _cleared(when, getattr(store.accum, f))
                             for f in _FIELDS}),
        accum_count=_cleared(when, store.accum_count),
        dropped=_select(when, store.dropped + dropped, store.dropped),
        kf_points=kf_pts, kf_counts=kf_counts)
