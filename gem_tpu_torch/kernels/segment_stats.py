"""Fused segment statistics (sum / min / max) over sorted segment ids.

Counterpart of gem_tpu/kernels/pallas_scatter.py.  `segment_stats_sorted`
is the wrapper of kernel K3: on CPU tensors it runs its plain PyTorch
version, `segment_stats_sorted_plain`; on CUDA tensors it launches
csrc/segment_stats.cu and adds the kernels launched to
`segment_stats_sorted.launches`: one per four columns, so one for each
`fuse_pallas` call, and none when no column or no segment is passed.  A
role whose results the caller drops takes a (0, N) stack and returns a
(0, S) result at no cost.

The TPU kernel walks fixed point chunks, each reducing into a window of
`window` cells starting at its chunk's first id (lane-aligned to 128);
points beyond their chunk's window "spill" and a jnp fallback adds them
back.  The CUDA kernel has no window: each block owns a range of segments
and reduces every point whose id lies there, so nothing spills and there
is no fallback.  The returned `n_spill` is kept as a diagnostic of the
TPU's window geometry: the count JAX reports for the same ids, `chunk` and
`window` (`spill_count`), computed here in plain torch.  The kernel ignores
both keywords; `pad_sort` pads to a `chunk` multiple as JAX does.

Robot axis (JAX's `vmap` of `pallas_segment_stats`, whose `pallas_call`
then gets a batch grid axis): ids (R, N) with local ids, columns (F, R, N).
`pad_sort` pads and sorts each robot to its own chunk-aligned block, and K3
takes the robots as a grid axis, each block searching its robot's range
only; results are (F, R, S), bitwise each robot's own call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gem_tpu_torch.kernels import _build


def pad_sort(ids, cols, num_segments: int, chunk: int = 1024):
    """Pad to a chunk multiple and sort ids + per-point columns once (one
    stable sort).  Returns (ids_sorted, cols_sorted (F, Npad)); invalid
    lanes hold num_segments and sort to the tail.  With a robot axis, ids
    (R, N) and cols (F, R, N), each robot is padded and sorted on its
    own: (R, Npad) and (F, R, Npad)."""
    pad = (-ids.shape[-1]) % chunk
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad), value=num_segments)
        cols = torch.nn.functional.pad(cols, (0, pad))
    ids_s, order = torch.sort(ids, dim=-1, stable=True)
    return ids_s, cols.gather(-1, order.expand(cols.shape))


def spill_count(ids_s, num_segments: int, chunk: int = 1024,
                window: int = 2048):
    """Real points that JAX's TPU kernel would spill: those whose id lies
    `window` or more past their chunk's lane-aligned first id
    (gem_tpu/kernels/pallas_scatter.py, the kernel's n_spill); (R,) for
    (R, N) ids."""
    n = ids_s.shape[-1]
    bases = torch.div(ids_s[..., ::chunk], 128, rounding_mode="floor") * 128
    bases = bases.repeat_interleave(chunk, dim=-1)[..., :n]
    spilled = (ids_s - bases >= window) & (ids_s < num_segments)
    return spilled.sum(-1, dtype=torch.int32)


def segment_stats_sorted_plain(ids_s, sum_vals, min_vals, max_vals,
                               num_segments: int):
    """Plain PyTorch version of K3: `index_add_` and `scatter_reduce_` on
    filled outputs (one dump column for ids >= num_segments, cut off).
    Returns (sums (F_s, S), mins (F_m, S), maxs (F_x, S)); with (R, N)
    ids and (F, R, N) columns, (F, R, S), robot r's ids folded to
    r * (S + 1) + id."""
    S = num_segments
    lead = ids_s.shape[:-1]
    nrob = math.prod(lead)
    ids = ids_s.to(torch.int64)
    ids = torch.where(ids < S, ids, S)
    ids = (ids + (S + 1) * torch.arange(nrob, device=ids.device).reshape(
        lead + (1,))).reshape(-1)
    f32 = dict(dtype=torch.float32, device=ids.device)
    flat = lambda vals: vals.reshape(vals.shape[0], ids.shape[0]).to(
        torch.float32)
    cut = lambda out: out.reshape((out.shape[0],) + lead + (S + 1,))[
        ..., :S]
    sums = torch.zeros((sum_vals.shape[0], nrob * (S + 1)), **f32)
    sums.index_add_(1, ids, flat(sum_vals))
    out = [cut(sums)]
    for vals, fill, kind in ((min_vals, float("inf"), "amin"),
                             (max_vals, float("-inf"), "amax")):
        red = torch.full((vals.shape[0], nrob * (S + 1)), fill, **f32)
        red.scatter_reduce_(1, ids.expand(vals.shape[0], -1), flat(vals),
                            kind)
        out.append(cut(red))
    return tuple(out)


def _segment_stats_cuda(ids_s, sum_vals, min_vals, max_vals,
                        num_segments: int):
    f32 = torch.float32
    n = ids_s.shape[-1]
    lead = ids_s.shape[:-1]
    nrob = ids_s.numel() // n if n else 0
    for name, vals in (("sum_vals", sum_vals), ("min_vals", min_vals),
                       ("max_vals", max_vals)):
        if vals.shape[1:] != ids_s.shape:
            raise ValueError(f"segment_stats_sorted: {name} must be (F, "
                             f"{', '.join(map(str, ids_s.shape))}), got "
                             f"{tuple(vals.shape)}")
    _build.check_tensors("segment_stats_sorted",
                         [sum_vals, min_vals, max_vals], [f32, f32, f32])
    if ids_s.device != sum_vals.device or ids_s.dim() not in (1, 2) \
            or ids_s.dtype not in (torch.int32, torch.int64):
        raise ValueError("segment_stats_sorted: ids_s must be a 1-D or "
                         "(R, N) int32 or int64 tensor on the values' "
                         "device")
    if not ids_s.is_contiguous():
        raise ValueError("segment_stats_sorted: ids_s must be contiguous")
    S = num_segments
    fs, fm = sum_vals.shape[0], min_vals.shape[0]
    # one allocation for the three results, returned as row views
    out = torch.empty((fs + fm + max_vals.shape[0],) + lead + (S,),
                      dtype=f32, device=ids_s.device)
    sums, mins, maxs = out[:fs], out[fs:fs + fm], out[fs + fm:]
    launched = ctypes.c_int(0)
    err = _build.library().gem_segment_stats_sorted(
        ids_s.data_ptr(), int(ids_s.dtype == torch.int64),
        sum_vals.data_ptr(), min_vals.data_ptr(), max_vals.data_ptr(),
        sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(), n, S, nrob, fs,
        fm, max_vals.shape[0], _build.stream_of(ids_s),
        ctypes.byref(launched))
    _build.check(err, "gem_segment_stats_sorted")
    segment_stats_sorted.launches += launched.value
    return sums, mins, maxs


def segment_stats_sorted(ids_s, sum_vals, min_vals, max_vals,
                         num_segments: int, chunk: int = 1024,
                         window: int = 2048, with_spill: bool = True):
    """Segment statistics over PRE-SORTED ids (invalid lanes ==
    num_segments): (sums (F_s, S), mins (F_m, S) with +inf where empty,
    maxs (F_x, S) with -inf where empty, n_spill ()).  Any of F_s, F_m,
    F_x may be 0.  With a robot axis, ids (R, N) each sorted on their own
    and columns (F, R, N): results (F, R, S) and n_spill (R,).

    Every point is reduced; `n_spill` is the TPU window's diagnostic count
    (see the module docstring), not a correction.  `with_spill=False`
    skips counting it (n_spill is None): `fuse_pallas` never reads it."""
    if ids_s.device.type == "cpu":
        stats = segment_stats_sorted_plain(ids_s, sum_vals, min_vals,
                                           max_vals, num_segments)
    elif ids_s.device.type == "cuda":
        stats = _segment_stats_cuda(ids_s, sum_vals, min_vals, max_vals,
                                    num_segments)
    else:
        raise ValueError(f"segment_stats_sorted: unsupported device "
                         f"{ids_s.device}")
    n_spill = spill_count(ids_s, num_segments, chunk, window) \
        if with_spill else None
    return (*stats, n_spill)


segment_stats_sorted.launches = 0


def segment_stats(ids, sum_vals, min_vals, max_vals, num_segments: int,
                  chunk: int = 1024, window: int = 2048):
    """Sort, then `segment_stats_sorted`.  `ids` need not be sorted;
    invalid lanes must hold num_segments.  (R, N) ids with (F, R, N)
    columns reduce each robot on its own."""
    all_cols = torch.cat([sum_vals, min_vals, max_vals], dim=0)
    ids_s, cols_s = pad_sort(ids, all_cols, num_segments, chunk)
    ns, nm = sum_vals.shape[0], min_vals.shape[0]
    return segment_stats_sorted(
        ids_s, cols_s[:ns], cols_s[ns:ns + nm], cols_s[ns + nm:],
        num_segments, chunk=chunk, window=window)
