"""Segment-reduce primitives for point->cell scatter.

Counterpart of gem_tpu/kernels/scatter.py.  These are XLA ops in the JAX
package (no Pallas), so plain PyTorch is their port.  Two backends, both
giving dense (num_segments,) outputs; ids >= num_segments are dropped:

  * "segment": `index_add_` for sums, `scatter_reduce_("amin"/"amax")` on
    an identity-filled output for min/max.
  * "sort": one stable sort by id shared by every reduction of a frame
    (`SortedSegments`); a sum is a cumsum minus the carry at each run
    start, min/max a running max restarted at run starts, and each run's
    end writes its segment.

The fill rule is JAX's: when `fill` is the reduction identity (+-inf, or
the int extremes) the reduction's own empty value stands; otherwise a
count decides which segments are empty.
"""

from __future__ import annotations

import torch

_IDENT_KIND = {"min": "amin", "max": "amax"}


def _reduce_identity(kind: str, dtype):
    if kind == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _segment_backend(values, ids, num_segments: int, kind: str):
    """(num_segments,) reduction of `values` by `ids` in [0, num_segments)."""
    if kind == "sum":
        out = torch.zeros(num_segments, dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, ids, values)
    if kind not in _IDENT_KIND:
        raise ValueError(kind)
    out = torch.full((num_segments,), _reduce_identity(kind, values.dtype),
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, ids, values, _IDENT_KIND[kind])


def _clip_ids(seg_ids, num_segments: int):
    """int64 ids with every id >= num_segments folded onto the dummy
    segment num_segments."""
    ids = seg_ids.to(torch.int64)
    return torch.where(ids < num_segments, ids, num_segments)


class SortedSegments:
    """Shared sorted view of one frame's point->cell assignment.

    Build once per frame; invalid points carry id == num_segments (they
    sort to the tail and fall into the dummy segment)."""

    def __init__(self, seg_ids, num_segments: int):
        self.num_segments = num_segments
        self.ids, self.order = torch.sort(seg_ids.to(torch.int64),
                                          stable=True)
        prev = torch.cat([self.ids.new_full((1,), -1), self.ids[:-1]])
        nxt = torch.cat([self.ids[1:],
                         self.ids.new_full((1,), num_segments + 1)])
        self.is_start = self.ids != prev
        self.is_end = self.ids != nxt
        self.valid = self.ids < num_segments
        # run index of every sorted position: keys of the restarted scans
        self.run = torch.cumsum(self.is_start.to(torch.int64), 0)

    def permute(self, values):
        return values[self.order]

    def _finalize(self, per_point, fill):
        """Collision-free scatter of run-end values into the dense output;
        other positions land in a dump slot that is cut off."""
        out = torch.full((self.num_segments + 1,), fill,
                         dtype=per_point.dtype, device=per_point.device)
        idx = torch.where(self.is_end & self.valid, self.ids,
                          self.num_segments)
        return out.scatter_(0, idx, per_point)[:self.num_segments]


def _ordered_bits(v):
    """Order-preserving uint32 image of float32 or int32 values, in int64."""
    if v.dtype == torch.float32:
        bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        neg = (bits & 0x80000000) != 0
        return torch.where(neg, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)
    if v.dtype == torch.int32:
        return (v.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    raise TypeError(f"min/max over sorted segments: unsupported {v.dtype}")


def _from_ordered_bits(u, dtype):
    if dtype == torch.float32:
        bits = torch.where(u >= 0x80000000, u ^ 0x80000000, u ^ 0xFFFFFFFF)
    else:
        bits = u ^ 0x80000000
    # low 32 bits as a signed int32, then reinterpreted
    bits = torch.where(bits >= 0x80000000, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(dtype)


def _restarted_max(run, u):
    """Running max of uint32 keys `u`, restarted at each new run index:
    one cummax of (run << 32 | u), since run indices only grow."""
    return torch.cummax((run << 32) | u, 0).values & 0xFFFFFFFF


def sorted_segment_reduce(ss: SortedSegments, values, kind: str, fill,
                          permuted: bool = False):
    """Segment reduction over a SortedSegments view.

    sum: inclusive cumsum minus the cumsum before each run's start.
    min/max: running max (of the flipped keys, for min) restarted at run
    starts; exact, so order-free."""
    v = values if permuted else ss.permute(values)
    if kind == "sum":
        c = torch.cumsum(v, 0, dtype=v.dtype)
        start_idx = torch.cummax(
            torch.where(ss.is_start, torch.arange(v.numel(),
                                                  device=v.device), 0),
            0).values
        per_point = c - (c - v)[start_idx]
    elif kind in ("min", "max"):
        u = _ordered_bits(v)
        if kind == "min":
            u = 0xFFFFFFFF - u
        u = _restarted_max(ss.run, u)
        if kind == "min":
            u = 0xFFFFFFFF - u
        per_point = _from_ordered_bits(u, v.dtype)
    else:
        raise ValueError(kind)
    return ss._finalize(per_point, fill)


def segment_reduce(values, seg_ids, num_segments: int, kind: str, fill,
                   backend: str = "segment",
                   ss: SortedSegments | None = None):
    """Dense (num_segments,) reduction of `values` grouped by seg_ids.

    Ids >= num_segments are dropped.  `fill` is the empty-segment value;
    when it equals the reduction identity no counts pass is needed."""
    if backend == "sort":
        if ss is None:
            ss = SortedSegments(seg_ids, num_segments)
        return sorted_segment_reduce(ss, values, kind, fill)
    ids = _clip_ids(seg_ids, num_segments)
    out = _segment_backend(values, ids, num_segments + 1, kind)[:num_segments]
    if kind == "sum" or fill == _reduce_identity(kind, values.dtype):
        return out
    counts = torch.zeros(num_segments + 1, dtype=torch.int32,
                         device=ids.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int32))[:num_segments]
    return torch.where(counts > 0, out, torch.full_like(out, fill))


def segment_argminmax(values, seg_ids, num_segments: int, kind: str,
                      valid=None):
    """Per-segment index of the min/max element; -1 for empty segments.
    Ties resolve to the smallest point index."""
    n = values.shape[0]
    ids = seg_ids if valid is None else torch.where(valid, seg_ids,
                                                    num_segments)
    ids = _clip_ids(ids, num_segments)
    live = ids < num_segments
    fill = float("inf") if kind == "min" else float("-inf")
    vals = torch.where(live, values, fill)
    best = _segment_backend(vals, ids, num_segments + 1,
                            kind)[:num_segments]
    winner = live & (vals == best[torch.clamp(ids, max=num_segments - 1)])
    idx = torch.where(winner, torch.arange(n, dtype=torch.int32,
                                           device=values.device), n)
    arg = _segment_backend(idx.to(torch.int32), ids, num_segments + 1,
                           "min")[:num_segments]
    return torch.where(arg < n, arg, -1)


def segment_count(seg_ids, num_segments: int, backend: str = "segment",
                  ss: SortedSegments | None = None):
    ones = torch.ones(seg_ids.shape, dtype=torch.int32,
                      device=seg_ids.device)
    if backend == "sort":
        if ss is None:
            ss = SortedSegments(seg_ids, num_segments)
        return sorted_segment_reduce(ss, ones, "sum", 0).to(torch.int32)
    ids = _clip_ids(seg_ids, num_segments)
    return _segment_backend(ones, ids, num_segments + 1,
                            "sum")[:num_segments]
