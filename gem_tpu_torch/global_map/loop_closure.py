"""Loop-closure re-stitch: batched submap re-transform + pairwise re-fusion.

Counterpart of gem_tpu/global_map/loop_closure.py (updateGlobalMap,
src/ElevationMapping.cpp:773-905, with the intended Kalman re-fusion of
SURVEY.md §7):
  e = (v_old*h_new + v_new*h_old) / (v_old + v_new)
  v =  v_old*v_new / (v_old + v_new)

Poses become (K, 4, 4) matrices, the re-transform is elementwise exact f32
over the stacked (K, C) submap tensors, overlap detection is a center
distance matrix, and the per-pair cell join is a sort-merge join: one stable
sort of the 2C packed keys `key << 1 | tag` (int64, so it cannot overflow)
per pair, then adjacent-row matching.  The pairs of a round are
vertex-disjoint, so a round is one batched sort over its (P, 2C) keys.
That is the plain join (`refuse_rounds_plain`, CPU tensors).  On CUDA
tensors a slot's keys, which depend only on its x, y and valid, are sorted
once per event (`_sorted_keys`) and each round with a valid pair is one
launch of kernel K4 (kernels/refuse_join.py), which joins last a row
against first b row, the rows the plain join's sort makes adjacent: the
same z, variance and count, bitwise.  One native call makes every round's
launches.  `apply_loop_closure` queues the sort before it plans the pairs
and hands it to the join, so the card sorts while the host plans: the plan
(`select_pairs`, `schedule_rounds`) is array operations, with the
schedule's first-fit as host code in the native library (native/).

Each `apply_loop_closure` call is one unit of the tracer
(utils/observability.py): the span `gem.restitch.apply` around it, with
children `gem.restitch.corrections`, `.transform`, `.select_pairs`,
`.schedule` and `.refuse` (on the CPU's plain join one `gem.restitch.round`
per round), a `gem.restitch.read` around each device->host read (the
centers' waits only for the transform, the others for every operation
queued before them) and a `gem.restitch.upload` around each host->device
copy (which waits for the device), counted as `restitch.reads` and
`restitch.uploads`; stamps `refuse` and `refused` around the join;
on the card, the counter `restitch.joins` for each K4 launch.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from gem_tpu_torch import native
from gem_tpu_torch.global_map.submaps import PointBuffer, SubmapStore
from gem_tpu_torch.kernels.refuse_join import refuse_join_rounds
from gem_tpu_torch.motion.updater import quat_to_rotmat
from gem_tpu_torch.utils.observability import TRACER
from gem_tpu_torch.utils.precision import f32_recip

_A_INVALID = 0xFFFFFFFE       # key of an invalid a-side row
_B_INVALID = 0xFFFFFFFF       # key of an invalid b-side row


def _read(t):
    """`t` on the host: a read, which waits for the device."""
    TRACER.count("restitch.reads")
    with TRACER.span("gem.restitch.read"):
        return t.cpu()


def _read_later(t):
    """Start reading `t` to the host, waiting only for what is queued so
    far: on the card a non-blocking copy into pinned memory and an event.
    Returns the function that waits for it (one of `restitch.reads`, in a
    `gem.restitch.read` span) and gives the host array."""
    if t.device.type != "cuda":
        return lambda: _read(t).numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def wait():
        TRACER.count("restitch.reads")
        with TRACER.span("gem.restitch.read"):
            copied.synchronize()
        return host.numpy()
    return wait


def _upload(a, device):
    """A host array on `device`: a pageable copy, which waits for the
    device too."""
    TRACER.count("restitch.uploads")
    with TRACER.span("gem.restitch.upload"):
        return torch.as_tensor(a, device=device)


def pose_to_matrix(poses7):
    """[..., (x, y, z, qw, qx, qy, qz)] -> [..., 4, 4]."""
    p = poses7.to(torch.float32)
    lead = p.shape[:-1]
    R = quat_to_rotmat(p.reshape(-1, 7)[:, 3:].T).permute(2, 0, 1)
    T = torch.eye(4, dtype=torch.float32, device=p.device).repeat(
        R.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = p.reshape(-1, 7)[:, :3]
    return T.reshape(*lead, 4, 4)


def _matmul(a, b):
    """Exact-f32 (..., n, k) @ (..., k, m), written out elementwise."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def relative_transforms(opt_poses, traj_poses):
    """(K, 4, 4) corrections T_k = opt_k @ traj_k^-1
    (src/ElevationMapping.cpp:795)."""
    To = pose_to_matrix(opt_poses)
    Tt = pose_to_matrix(traj_poses)
    Rt = Tt[:, :3, :3].transpose(1, 2)
    inv = torch.eye(4, dtype=torch.float32, device=To.device).repeat(
        To.shape[0], 1, 1)
    inv[:, :3, :3] = Rt
    inv[:, :3, 3] = _matmul(-Rt, Tt[:, :3, 3:])[..., 0]
    return _matmul(To, inv)


def transform_submaps(slots: PointBuffer, transforms) -> PointBuffer:
    """Apply per-submap rigid corrections to the stacked point tensors."""
    R = transforms[:, :3, :3, None]                  # (K, 3, 3, 1)
    t = transforms[:, :3, 3, None]                   # (K, 3, 1)
    x, y, z = slots.x, slots.y, slots.z
    moved = [R[:, i, 0] * x + R[:, i, 1] * y + R[:, i, 2] * z + t[:, i]
             for i in range(3)]
    return slots.replace(x=moved[0], y=moved[1], z=moved[2])


def _quantize(x, y, resolution: float):
    """Reference cell key (pointCloudtoHash, src/ElevationMapping.cpp:1184):
    ceil(x/res), with `/ res` as the reference's jit folds it."""
    inv = f32_recip(resolution)
    return (torch.ceil(x * inv).to(torch.int32),
            torch.ceil(y * inv).to(torch.int32))


def _pack(qx, qy):
    """(qx, qy) -> one key in [0, 2^32); coordinates alias every 65536 cells
    (~6.5 km at 0.1 m), far beyond a pair of overlapping submaps."""
    return ((qx.to(torch.int64) & 0xFFFF) << 16) | (qy.to(torch.int64)
                                                    & 0xFFFF)


def _refuse(az, av, ax, ay, a_ok, bz, bv, bx, by, b_ok, resolution):
    """The join of `refuse_pair` over a leading batch of pairs: (..., C)
    rows in, fused (az, av, bz, bv) and the per-pair fused-cell count out."""
    C = az.shape[-1]
    key_a = torch.where(a_ok, _pack(*_quantize(ax, ay, resolution)),
                        _A_INVALID)
    key_b = torch.where(b_ok, _pack(*_quantize(bx, by, resolution)),
                        _B_INVALID)
    # (key, tag) in one int64: within a key the a rows (tag 0) precede the
    # b rows; the stable sort keeps source order within equal (key, tag),
    # as the reference's lexsort does
    packed = torch.cat([key_a << 1, (key_b << 1) | 1], dim=-1)
    packed_s, order = torch.sort(packed, dim=-1, stable=True)
    z_s = torch.cat([az, bz], dim=-1).gather(-1, order)
    v_s = torch.cat([av, bv], dim=-1).gather(-1, order)
    k_s, t_s = packed_s >> 1, packed_s & 1
    i_s = order % C                                  # source row on its side

    # row r matches when row r-1 is the a row of the same key and row r a b
    # row (one fused pair per duplicate run)
    match = (k_s[..., 1:] == k_s[..., :-1]) & (t_s[..., 1:] == 1) \
        & (t_s[..., :-1] == 0) & (k_s[..., 1:] < _A_INVALID)
    v_old, h_old = v_s[..., :-1], z_s[..., :-1]      # a side
    v_new, h_new = v_s[..., 1:], z_s[..., 1:]
    gate = match & (v_old > 0.0) & (v_old < 1.0)
    denom = torch.clamp(v_old + v_new, min=1e-12)
    fused_z = (v_old * h_new + v_new * h_old) / denom
    fused_v = v_old * v_new / denom

    # each gated a row and b row occurs once; the other rows write into a
    # dump column C that is cut off (no host read of the gate)
    a_tgt = torch.where(gate, i_s[..., :-1], C)
    b_tgt = torch.where(gate, i_s[..., 1:], C)
    return (_scatter_rows(az, a_tgt, fused_z),
            _scatter_rows(av, a_tgt, fused_v),
            _scatter_rows(bz, b_tgt, fused_z),
            _scatter_rows(bv, b_tgt, fused_v),
            gate.sum(dim=-1, dtype=torch.int32))


def _scatter_rows(base, tgt, val):
    """base[..., tgt] = val along the last dim; tgt == C lands in a dump
    column."""
    ext = torch.cat([base, base.new_zeros(base.shape[:-1] + (1,))], dim=-1)
    return ext.scatter(-1, tgt, val)[..., :-1]


def refuse_pair(a: PointBuffer, b: PointBuffer, resolution: float):
    """Fuse co-located cells of two (C,) submap buffers, returning both
    updated and the number of fused cells.  Gate: the a-side variance must
    lie in (0, 1) (src/ElevationMapping.cpp:859)."""
    az, av, bz, bv, n = _refuse(a.z, a.variance, a.x, a.y, a.valid,
                                b.z, b.variance, b.x, b.y, b.valid,
                                resolution)
    return (a.replace(z=az, variance=av), b.replace(z=bz, variance=bv), n)


def refuse_pairs(slots: PointBuffer, pairs, pair_valid, resolution: float):
    """Re-fuse a padded (P, 2) list of submap pairs one after another, later
    pairs seeing earlier results (src/ElevationMapping.cpp:840-883): each
    pair is a round of its own.  pair_valid (P,) masks padding lanes."""
    return refuse_rounds(slots, np.asarray(pairs)[:, None],
                         np.asarray(pair_valid)[:, None], resolution)


def refuse_rounds(slots: PointBuffer, rounds, rounds_valid,
                  resolution: float):
    """Re-fuse pairs in vertex-disjoint rounds: within a round every pair
    touches different submaps, so a round is one batched join and one masked
    write-back; rounds run in order.  Equal to the sequential `refuse_pair`
    chain taken in round-major order.  CUDA tensors go to K4
    (`_refuse_rounds_sorted`), others to `refuse_rounds_plain`; the
    caller's tensors are not written.

    rounds       : (R, P, 2) slot indices (int tensor or array)
    rounds_valid : (R, P) bool — padding lanes are no-ops
    Returns (slots, total fused cells as a 0-d int tensor).
    """
    if slots.z.device.type == "cuda":
        return _refuse_rounds_sorted(slots, rounds, rounds_valid,
                                     _sorted_keys(slots, resolution))
    return refuse_rounds_plain(slots, rounds, rounds_valid, resolution)


def _sorted_keys(slots: PointBuffer, resolution: float):
    """Each slot's cell keys sorted, stably: ((K, C) int64 keys, (K, C)
    int32 source rows).  An invalid row's key is _A_INVALID, which never
    fuses.  One flat stable sort of `slot << 32 | key` (keys are below
    2^32), which is each slot's own stable sort, in one radix sort."""
    K, C = slots.x.shape
    key = torch.where(slots.valid, _pack(*_quantize(slots.x, slots.y,
                                                    resolution)), _A_INVALID)
    slot = torch.arange(K, device=key.device)[:, None]
    flat, order = torch.sort((key | slot << 32).reshape(-1), stable=True)
    return ((flat & 0xFFFFFFFF).reshape(K, C),
            (order.reshape(K, C) - slot * C).to(torch.int32))


def _refuse_rounds_sorted(slots: PointBuffer, rounds, rounds_valid,
                          sorted_keys):
    """`refuse_rounds` on the card from `sorted_keys`, the slots'
    `_sorted_keys`: every round's K4 launches in one native call, on clones
    of z and variance."""
    keys, rows = sorted_keys
    z = slots.z.clone(memory_format=torch.contiguous_format)
    var = slots.variance.clone(memory_format=torch.contiguous_format)
    total = torch.zeros((), dtype=torch.int64, device=z.device)
    TRACER.count("restitch.joins", refuse_join_rounds(
        keys, rows, z, var, rounds, rounds_valid, total))
    return slots.replace(z=z, variance=var), total


def refuse_rounds_plain(slots: PointBuffer, rounds, rounds_valid,
                        resolution: float):
    """The plain `refuse_rounds`: each round one batched `_refuse` over its
    (P, C) lanes, padding lanes included, and an indexed write-back (the
    padding lanes' into a dump row)."""
    dev = slots.z.device
    K, C = slots.z.shape
    rounds = _upload(np.asarray(rounds), dev).long()
    rounds_valid = _upload(np.asarray(rounds_valid), dev)
    # one dump row K for the padding lanes' write-back, cut off at the end
    pad = lambda a: torch.cat([a, a.new_zeros((1, C))])
    z, var = pad(slots.z), pad(slots.variance)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for r in range(rounds.shape[0]):
        with TRACER.span("gem.restitch.round"):
            i, j, ok = rounds[r, :, 0], rounds[r, :, 1], rounds_valid[r]
            az, av, bz, bv, n = _refuse(
                z[i], var[i], slots.x[i], slots.y[i], slots.valid[i],
                z[j], var[j], slots.x[j], slots.y[j], slots.valid[j],
                resolution)
            ti, tj = torch.where(ok, i, K), torch.where(ok, j, K)
            z[ti], var[ti] = az, av
            z[tj], var[tj] = bz, bv
            total = total + torch.where(ok, n, 0).sum()
    return slots.replace(z=z[:K], variance=var[:K]), total


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def select_pairs(centers: np.ndarray, radius: float,
                 max_per_submap: int) -> list:
    """Directed overlap pairs, capped at each submap's `max_per_submap`
    NEAREST neighbours (the reference's kd radius query is uncapped,
    src/ElevationMapping.cpp:834-839).  Order matches the uncapped
    i-major enumeration so capped == uncapped whenever the cap is slack.
    As array operations: a distance mask marks each submap's candidates, a
    stable argsort of the masked distances ranks them (ties in j order, as
    a stable sort by distance leaves them), and the candidates ranked below
    the cap are read out i-major, j ascending, as (int, int) tuples.  The
    distances are `np.linalg.norm`'s arithmetic over (x, y), written out."""
    n = centers.shape[0]
    dx = centers[:, None, 0] - centers[None, :, 0]
    dy = centers[:, None, 1] - centers[None, :, 1]
    d = np.sqrt(dx * dx + dy * dy)
    near = d < radius
    np.fill_diagonal(near, False)
    order = np.argsort(np.where(near, d, np.inf), axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(n)[None, :], axis=1)
    i, j = np.nonzero(near & (rank < max_per_submap))
    return list(zip(i.tolist(), j.tolist()))


def _pair_array(pairs) -> np.ndarray:
    """(i, j) pairs, a list of tuples or an array, as an (n, 2) int32
    array."""
    if isinstance(pairs, np.ndarray):
        return pairs.astype(np.int32, copy=False).reshape(-1, 2)
    return np.fromiter(itertools.chain.from_iterable(pairs), np.int32,
                       2 * len(pairs)).reshape(-1, 2)


def schedule_rounds(pairs) -> tuple[np.ndarray, np.ndarray]:
    """First-fit matching schedule: each pair goes to the first round where
    neither submap is already used, so pairs within a round are
    vertex-disjoint (safe to vmap) and the round count is bounded by the
    graph's edge-chromatic number (~max submap degree), NOT the pair
    count.  The resulting canonical fusion order is round-major; see
    refuse_rounds.  `pairs`: a list of (i, j) or an (n, 2) array of slots
    >= 0.  Returns (rounds (R, P, 2) i32, valid (R, P) bool), both padded to
    powers of two to bound recompiles across events.  The first-fit is
    `native.first_fit_rounds`; NumPy places the pairs."""
    p = _pair_array(pairs)
    rnd, lane, n_rounds, max_lanes = native.first_fit_rounds(p)
    rounds = np.zeros((_next_pow2(max(n_rounds, 1)),
                       _next_pow2(max(max_lanes, 1)), 2), np.int32)
    valid = np.zeros(rounds.shape[:2], bool)
    rounds[rnd, lane] = p
    valid[rnd, lane] = True
    return rounds, valid


def slot_corrections(store: SubmapStore, opt_poses):
    """Map trajectory-indexed optimized poses onto ring slots by keyframe id.

    `opt_poses` is (K', 7) indexed by global keyframe id, like the
    reference's globalMap_ vector (src/ElevationMapping.cpp:784-786, clamped
    the same way); after the ring wraps each slot is matched through its
    `kf_ids` entry.  Returns host NumPy (opt_full (K, 7), participates (K,),
    transform_mask (K,)); transform_mask also excludes keyframe 0, the
    reference's rigid anchor (src/ElevationMapping.cpp:794).  Reads the
    store's ids and poses to the host once per loop event."""
    ids = _read(store.kf_ids).numpy()
    opt_np = np.asarray(opt_poses, np.float32).reshape(-1, 7)
    n_opt = int(min(opt_np.shape[0], int(_read(store.num_submaps))))
    participates = (ids >= 0) & (ids < n_opt)
    opt_full = _read(store.poses).numpy().copy()
    opt_full[participates] = opt_np[ids[participates]]
    transform_mask = participates & (ids != 0)
    return opt_full, participates, transform_mask


def apply_loop_closure(store: SubmapStore, cfg,
                       opt_poses) -> tuple[SubmapStore, dict]:
    """Full re-stitch: correct submap poses, re-transform stacked clouds,
    re-fuse overlapping pairs.  `opt_poses` is (K', 7) indexed by global
    keyframe id; slots are matched by their stored keyframe id, so the
    pairing survives ring wrap."""
    with TRACER.unit(), TRACER.span("gem.restitch.apply"):
        return _restitch(store, cfg, opt_poses)


def _restitch(store: SubmapStore, cfg, opt_poses):
    with TRACER.span("gem.restitch.corrections"):
        opt_full, part, tmask = slot_corrections(store, opt_poses)
    n = int(part.sum())
    if n == 0:
        return store, {"n_corrected": 0, "n_pairs": 0, "n_cells_fused": 0}

    dev = store.poses.device
    with TRACER.span("gem.restitch.transform"):
        opt = _upload(opt_full, dev)
        T = relative_transforms(opt, store.poses)
        eye = torch.eye(4, dtype=torch.float32, device=dev).expand_as(T)
        full_T = torch.where(_upload(tmask, dev)[:, None, None], T, eye)
        moved = transform_submaps(store.slots, full_T)
        part_dev = _upload(part, dev)
        poses = torch.where(part_dev[:, None], opt, store.poses)
        centers = torch.where(part_dev[:, None], opt[:, :2], store.centers)

    # overlap pairs among corrected submaps (center distance < radius),
    # bounded at nearest-M per submap, batched into vertex-disjoint rounds;
    # on the card the keys are sorted meanwhile, queued after the centers'
    # copy so that its read waits only for the transform (a pair needs two
    # corrected submaps)
    idx = np.nonzero(part)[0]
    res = cfg.submap.dedup_cell_quantum or cfg.map.resolution
    read_centers = _read_later(centers)
    keys = (_sorted_keys(moved, res) if dev.type == "cuda" and n > 1
            else None)
    centers_np = read_centers()
    with TRACER.span("gem.restitch.select_pairs"):
        pairs = idx[_pair_array(select_pairs(
            centers_np[idx], cfg.submap.overlap_radius,
            cfg.submap.max_pairs_per_submap))]
    slots = moved
    n_cells = 0
    n_rounds = 0
    if len(pairs):
        with TRACER.span("gem.restitch.schedule"):
            rounds, valid = schedule_rounds(pairs)
        n_rounds = rounds.shape[0]
        with TRACER.span("gem.restitch.refuse"):
            TRACER.mark("refuse", dev)
            slots, nf = (refuse_rounds(moved, rounds, valid, res)
                         if keys is None else
                         _refuse_rounds_sorted(moved, rounds, valid, keys))
            TRACER.mark("refused", dev)
            n_cells = int(_read(nf))

    new_store = store.replace(slots=slots, poses=poses, centers=centers)
    return new_store, {"n_corrected": n, "n_pairs": len(pairs),
                       "n_rounds": n_rounds, "n_cells_fused": n_cells}
