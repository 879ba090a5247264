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

Each `apply_loop_closure` call is one unit of the tracer
(utils/observability.py): the span `gem.restitch.apply` around it, with
children `gem.restitch.corrections`, `.transform`, `.select_pairs`,
`.schedule` and `.refuse` (one `gem.restitch.round` per round), a
`gem.restitch.read` around each device->host read and a
`gem.restitch.upload` around each host->device copy (both wait for every
operation queued before them), counted as `restitch.reads` and
`restitch.uploads`; stamps `refuse` and `refused` around `refuse_rounds`.
"""

from __future__ import annotations

import numpy as np
import torch

from gem_tpu_torch.global_map.submaps import PointBuffer, SubmapStore
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
    chain taken in round-major order.

    rounds       : (R, P, 2) slot indices (int tensor or array)
    rounds_valid : (R, P) bool — padding lanes are no-ops
    Returns (slots, total fused cells as a 0-d int tensor).
    """
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
    i-major enumeration so capped == uncapped whenever the cap is slack."""
    n = centers.shape[0]
    d = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    pairs = []
    for i in range(n):
        js = [j for j in range(n) if j != i and d[i, j] < radius]
        if len(js) > max_per_submap:
            js_sorted = sorted(js, key=lambda j: d[i, j])[:max_per_submap]
            keep = set(js_sorted)
            js = [j for j in js if j in keep]   # preserve j-order
        pairs.extend((i, j) for j in js)
    return pairs


def schedule_rounds(pairs: list) -> tuple[np.ndarray, np.ndarray]:
    """First-fit matching schedule: each pair goes to the first round where
    neither submap is already used, so pairs within a round are
    vertex-disjoint (safe to vmap) and the round count is bounded by the
    graph's edge-chromatic number (~max submap degree), NOT the pair
    count.  The resulting canonical fusion order is round-major; see
    refuse_rounds.  Returns (rounds (R, P, 2) i32, valid (R, P) bool),
    both padded to powers of two to bound recompiles across events."""
    used: list = []       # per round: set of submaps touched
    levels: list = []
    for (i, j) in pairs:
        for r in range(len(levels)):
            if i not in used[r] and j not in used[r]:
                levels[r].append((i, j))
                used[r].update((i, j))
                break
        else:
            levels.append([(i, j)])
            used.append({i, j})
    R = _next_pow2(max(len(levels), 1))
    P = _next_pow2(max((len(l) for l in levels), default=1))
    rounds = np.zeros((R, P, 2), np.int32)
    valid = np.zeros((R, P), bool)
    for r, l in enumerate(levels):
        rounds[r, :len(l)] = np.asarray(l, np.int32)
        valid[r, :len(l)] = True
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
        slots = transform_submaps(store.slots, full_T)
        part_dev = _upload(part, dev)
        poses = torch.where(part_dev[:, None], opt, store.poses)
        centers = torch.where(part_dev[:, None], opt[:, :2], store.centers)

    # overlap pairs among corrected submaps (center distance < radius),
    # bounded at nearest-M per submap, batched into vertex-disjoint rounds
    idx = np.nonzero(part)[0]
    centers_np = _read(centers).numpy()
    with TRACER.span("gem.restitch.select_pairs"):
        sub_pairs = select_pairs(centers_np[idx], cfg.submap.overlap_radius,
                                 cfg.submap.max_pairs_per_submap)
        pairs = [(int(idx[i]), int(idx[j])) for i, j in sub_pairs]

    res = cfg.submap.dedup_cell_quantum or cfg.map.resolution
    n_cells = 0
    n_rounds = 0
    if pairs:
        with TRACER.span("gem.restitch.schedule"):
            rounds, valid = schedule_rounds(pairs)
        n_rounds = rounds.shape[0]
        with TRACER.span("gem.restitch.refuse"):
            TRACER.mark("refuse", dev)
            slots, nf = refuse_rounds(slots, rounds, valid, res)
            TRACER.mark("refused", dev)
            n_cells = int(_read(nf))

    new_store = store.replace(slots=slots, poses=poses, centers=centers)
    return new_store, {"n_corrected": n, "n_pairs": len(pairs),
                       "n_rounds": n_rounds, "n_cells_fused": n_cells}
