"""K4: one round of the loop-closure re-stitch's pair join
(csrc/refuse_join.cu).

No TPU kernel: added for the re-stitch join.  `refuse_join` joins a round's
vertex-disjoint pairs of slots from each slot's cell keys, sorted once per
event by `global_map/loop_closure.py` `_sorted_keys`, and re-fuses their z
and variance in place; `refuse_join_rounds` makes the launches of every
round of an event in one native call, the same launches in the same order.
Each launch adds to `refuse_join.launches`.  Its plain version is the
per-round sort-merge join of `loop_closure._refuse`, which `refuse_rounds`
runs on CPU tensors; on CUDA tensors `refuse_rounds` calls
`refuse_join_rounds` once per event.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gem_tpu_torch.kernels import _build


def _check_join(name, keys_s, rows_s, z, variance, total) -> None:
    if keys_s.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {keys_s.device} "
                         f"(the plain join is loop_closure._refuse)")
    _build.check_tensors(name, [keys_s, rows_s, z, variance, total],
                         [torch.int64, torch.int32, torch.float32,
                          torch.float32, torch.int64])
    if any(t.shape != keys_s.shape for t in (rows_s, z, variance)) \
            or keys_s.dim() != 2 or total.shape != ():
        raise ValueError(f"{name}: keys, rows, z and variance must be "
                         f"(K, C) and total 0-d")


def refuse_join(keys_s, rows_s, z, variance, pairs, total) -> int:
    """Re-fuse `pairs` ((n, 2) host slot indices (a, b), no slot twice) in
    place: z and variance (K, C) f32, from keys_s (K, C) int64 (each slot's
    keys sorted, stably) and rows_s (K, C) int32 (each sorted key's source
    row); the fused-cell count is added to `total` (0-d int64).  Returns the
    kernels launched (none without a pair)."""
    _check_join("refuse_join", keys_s, rows_s, z, variance, total)
    K, C = keys_s.shape
    pairs = np.ascontiguousarray(pairs, dtype=np.int32).reshape(-1, 2)
    if pairs.size and (pairs.min() < 0 or pairs.max() >= K
                       or np.unique(pairs).size != pairs.size):
        raise ValueError(f"refuse_join: pairs must be slots in [0, {K}), "
                         f"none twice: {pairs.tolist()}")
    launched = ctypes.c_int(0)
    err = _build.library().gem_refuse_join(
        pairs.ctypes.data, pairs.shape[0], keys_s.data_ptr(),
        rows_s.data_ptr(), z.data_ptr(), variance.data_ptr(), C,
        total.data_ptr(), _build.stream_of(keys_s), ctypes.byref(launched))
    _build.check(err, "gem_refuse_join")
    refuse_join.launches += launched.value
    return launched.value


refuse_join.launches = 0


def refuse_join_rounds(keys_s, rows_s, z, variance, rounds, valid,
                       total) -> int:
    """`refuse_join` for every round of an event, in one native call:
    rounds (R, P, 2) host slot indices, valid (R, P) host bool; each round's
    valid lanes, in lane order, are that round's pairs, and a round without
    one launches nothing.  Every round is checked before the first launch
    (slots in [0, K), none twice within a round).  Returns the kernels
    launched."""
    _check_join("refuse_join_rounds", keys_s, rows_s, z, variance, total)
    K, C = keys_s.shape
    rounds = np.ascontiguousarray(rounds, dtype=np.int32)
    valid = np.ascontiguousarray(valid, dtype=np.bool_)
    R, P = valid.shape
    if rounds.shape != (R, P, 2):
        raise ValueError(f"refuse_join_rounds: rounds {rounds.shape} and "
                         f"valid {valid.shape} must be (R, P, 2) and (R, P)")
    launched = ctypes.c_int(0)
    err = _build.library().gem_refuse_join_rounds(
        rounds.ctypes.data, valid.ctypes.data, R, P, K, keys_s.data_ptr(),
        rows_s.data_ptr(), z.data_ptr(), variance.data_ptr(), C,
        total.data_ptr(), _build.stream_of(keys_s), ctypes.byref(launched))
    if err < 0:
        what = (f"a slot outside [0, {K})" if err == -1
                else "a slot twice within a round")
        raise ValueError(f"refuse_join_rounds: {what}; nothing launched")
    _build.check(err, "gem_refuse_join_rounds")
    refuse_join.launches += launched.value
    return launched.value

