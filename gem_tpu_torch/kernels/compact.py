"""K5: the submap store's compaction (csrc/compact_append.cu).

No TPU kernel: added for the compaction.  The JAX package scatters every
input of `_compact_append` (gem_tpu/global_map/submaps.py), the invalid
ones to a dump row, and leaves it to XLA.  `compact_append` appends each
leading index's valid inputs to its point buffer: CPU tensors run the plain
version, `compact_append_plain` (a cumsum, a `searchsorted` and a gather
per field); CUDA tensors launch K5 (two kernels: the tiles' valid counts,
then the ranked writes) and add one to `compact_append.launches`.  The
store (`global_map/submaps.py`) calls it for the shed append, the staging
flush and the keyframe finalize.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gem_tpu_torch.kernels import _build
from gem_tpu_torch.utils.tree import flat_rows

_FIELDS = ("x", "y", "z", "variance", "intensity", "traver", "color",
           "valid")
_DTYPES = (torch.float32,) * 6 + (torch.int32, torch.bool)
_TILE = 4096          # inputs a block of K5's passes (kTile in the source)
_MAX_ROWS = 65535     # a launch's grid rows


def compact_append(buf, count, new):
    """Append new.valid points into buf at positions [count, ...),
    compacted: the i-th valid input goes to count + (#valid before i);
    inputs past the capacity are dropped and counted.  `buf` (..., C),
    `count` (...), `new` (..., n), PointBuffers of one leading shape: one
    append per leading index.  Returns (the new buffer, count + appended,
    dropped).  Raises on other shapes and dtypes.  CPU tensors, and an
    empty `new`, run `compact_append_plain`; CUDA tensors launch K5,
    bitwise the same."""
    lead, C = tuple(buf.valid.shape[:-1]), buf.valid.shape[-1]
    n = new.valid.shape[-1]
    ins = [getattr(new, f).contiguous() for f in _FIELDS]
    olds = [getattr(buf, f).contiguous() for f in _FIELDS]
    if any(t.shape != lead + (n,) for t in ins) \
            or any(t.shape != lead + (C,) for t in olds) \
            or count.shape != lead:
        raise ValueError(f"compact_append: expected every field of `new` "
                         f"{lead + (n,)}, of `buf` {lead + (C,)} and count "
                         f"{lead}")
    count = count.contiguous()
    _build.check_tensors("compact_append", ins + olds + [count],
                         _DTYPES + _DTYPES + (torch.int32,))
    dev = count.device
    if dev.type == "cpu" or n == 0:
        return compact_append_plain(buf, count, new)
    if dev.type != "cuda":
        raise ValueError(f"compact_append: unsupported device {dev}")
    rows = math.prod(lead)
    if rows > _MAX_ROWS or n >= 2 ** 31 or C >= 2 ** 31:
        raise ValueError(f"compact_append: {rows} rows of {n} inputs into "
                         f"{C}: at most {_MAX_ROWS} rows, under 2^31 each")
    outs = [torch.empty_like(t) for t in olds]
    out_count, dropped = torch.empty_like(count), torch.empty_like(count)
    tile_counts = torch.empty((rows, -(-n // _TILE)), dtype=torch.int32,
                              device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr()
                                                     for t in ts))
    err = _build.library().gem_compact_append(
        ptrs(ins), ptrs(olds), ptrs(outs), count.data_ptr(),
        out_count.data_ptr(), dropped.data_ptr(), tile_counts.data_ptr(),
        rows, n, C, _build.stream_of(count))
    _build.check(err, "gem_compact_append")
    compact_append.launches += 1
    return type(buf)(**dict(zip(_FIELDS, outs))), out_count, dropped


compact_append.launches = 0


def compact_append_plain(buf, count, new):
    """`compact_append` in plain PyTorch.

    Written as a gather: output row j >= count takes the valid input of
    rank j - count, found by `searchsorted` on the running count of valid
    inputs, so the work is (capacity) gathers plus one cumsum whatever the
    input size.  The JAX version scatters every input, the invalid ones to
    a dump row; both place every point alike.  Every output color passes
    through f32 as in JAX's stacked scatter (exact for rgb < 2^24)."""
    C = buf.capacity
    n = new.valid.shape[-1]
    if n == 0:
        return buf, count, torch.zeros_like(count)
    ranks = torch.cumsum(new.valid, -1, dtype=torch.int32)  # inclusive
    total = ranks[..., -1]
    appended = torch.clamp(torch.minimum(total, C - count), min=0)
    rank = torch.arange(C, dtype=torch.int32, device=ranks.device) \
        - count[..., None]
    take = (rank >= 0) & (rank < appended[..., None])
    src = torch.clamp(torch.searchsorted(ranks, rank + 1), max=n - 1)
    src = flat_rows(src, n)       # into every leading index's inputs
    pick = lambda f: torch.where(take, getattr(new, f).reshape(-1)[src],
                                 getattr(buf, f))
    out = type(buf)(
        x=pick("x"), y=pick("y"), z=pick("z"), variance=pick("variance"),
        intensity=pick("intensity"), traver=pick("traver"),
        color=pick("color").to(torch.float32).to(torch.int32),
        valid=take | buf.valid)
    return out, count + appended, total - appended
