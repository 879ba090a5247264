"""Sharded global map: the submap ring split over the ranks of a process
group.

Counterpart of gem_tpu/global_map/sharded.py.  Each rank holds a contiguous
range of K / n slots (`shard_store`); at a loop closure:

  * pose correction and re-transform are local to each rank
    (`slot_corrections`, `relative_transforms`, `transform_submaps`);
  * cross-shard re-fusion is a ring sweep: n steps, each re-fusing every
    local slot against every buffer visiting from the ring, then passing
    the visiting buffers, centers and participation flags on with
    `ring_shift` (the counterpart of JAX's `ppermute`);
  * the fused-cell count is one `all_reduce`.

The sweep is not `apply_loop_closure`'s rounds, and keeps the JAX sweep's
semantics: the visiting buffers are the slots as they were before the
sweep; each pair meets twice, and each side gates it on its own (the
reference's asymmetric hash iteration, src/ElevationMapping.cpp:846-884);
slot i's refusals accumulate in visiting order.  Since a visiting buffer is
never written, the local slots are independent of each other within a
step: for each visiting slot j, one batched join re-fuses every local slot
against it (`loop_closure._refuse`), gated lane by lane.
"""

from __future__ import annotations

import functools

import torch

from gem_tpu_torch.global_map.loop_closure import (_refuse,
                                                   relative_transforms,
                                                   slot_corrections,
                                                   transform_submaps)
from gem_tpu_torch.global_map.submaps import SubmapStore
from gem_tpu_torch.multirobot import distributed as mdist


def shard_store(store: SubmapStore, group=None) -> SubmapStore:
    """This rank's range of slots of a full store: slots, counts, centers,
    poses and kf_ids cut to [rank * K/n, (rank + 1) * K/n); the ring's
    scalar state and the accumulator stay whole (replicated).  K must
    divide by the group size."""
    rank, n = mdist.rank_and_size(group)
    K = store.counts.shape[0]
    if K % n:
        raise ValueError(f"max_submaps={K} not divisible by {n} shards")
    k = K // n
    cut = lambda a: a[rank * k:(rank + 1) * k]
    return store.replace(
        slots=store.slots.replace(**{
            f: cut(getattr(store.slots, f)) for f in (
                "x", "y", "z", "variance", "intensity", "traver", "color",
                "valid")}),
        counts=cut(store.counts), centers=cut(store.centers),
        poses=cut(store.poses), kf_ids=cut(store.kf_ids))


def _sweep(cfg, group, slots, counts, centers, poses, opt_poses,
           transform_mask, participates):
    """The loop-closure body on this rank's slots: local correction and
    re-transform, then the ring sweep; -> (slots, centers, poses, cells
    fused over all ranks)."""
    res = cfg.submap.dedup_cell_quantum or cfg.map.resolution
    radius2 = cfg.submap.overlap_radius ** 2
    n_shards = mdist.rank_and_size(group)[1]
    dev = slots.z.device
    # local pose correction + re-transform: poses/centers of every
    # participating slot, the rigid transform of all but keyframe 0
    T = relative_transforms(opt_poses, poses)
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand_as(T)
    T = torch.where(transform_mask[:, None, None], T, eye)
    slots = transform_submaps(slots, T)
    poses = torch.where(participates[:, None], opt_poses, poses)
    centers = torch.where(participates[:, None], opt_poses[:, :2], centers)

    # ring sweep; pairs only among participating (corrected) slots
    k_local = counts.shape[0]
    lane = torch.arange(k_local, device=dev)
    mine = (counts > 0) & participates
    z, var = slots.z, slots.variance
    visiting = [slots.x, slots.y, slots.z, slots.variance, slots.valid,
                centers, participates & (counts > 0)]
    n_fused = torch.zeros((), dtype=torch.int64, device=dev)
    for step in range(n_shards):
        vx, vy, vz, vv, vok, v_centers, v_part = visiting
        for j in range(k_local):
            d2 = ((centers - v_centers[j]) ** 2).sum(dim=1)
            do = (d2 < radius2) & v_part[j] & mine
            if step == 0:
                do = do & (lane != j)
            shape = z.shape
            az, av, _, _, nf = _refuse(
                z, var, slots.x, slots.y, slots.valid,
                vz[j].expand(shape), vv[j].expand(shape),
                vx[j].expand(shape), vy[j].expand(shape),
                vok[j].expand(shape), res)
            z = torch.where(do[:, None], az, z)
            var = torch.where(do[:, None], av, var)
            n_fused = n_fused + torch.where(do, nf, 0).sum()
        if step + 1 < n_shards:
            visiting = mdist.ring_shift_tensors(visiting, group)
    total = mdist.all_reduce_sum(n_fused, group)
    return slots.replace(z=z, variance=var), centers, poses, total


def sharded_loop_closure(cfg, group=None):
    """The loop-closure body for `group`: fn(slots, counts, centers, poses,
    opt_poses, transform_mask, participates) -> (slots, centers, poses,
    cells fused over all ranks), every argument this rank's slots."""
    return functools.partial(_sweep, cfg, group)


def apply_sharded_loop_closure(store: SubmapStore, cfg, opt_poses,
                               group=None) -> tuple[SubmapStore, dict]:
    """The loop-closure event on this rank's shard (`shard_store`):
    trajectory-indexed `opt_poses` (K', 7) map onto slots by keyframe id
    (ring-wrap safe), the sweep runs over `group`, and the shard comes back
    with its slots re-transformed and re-fused.  Stats are global."""
    opt_full, participates, transform_mask = slot_corrections(store,
                                                              opt_poses)
    dev = store.poses.device
    fn = sharded_loop_closure(cfg, group)
    slots, centers, poses, n_fused = fn(
        store.slots, store.counts, store.centers, store.poses,
        torch.from_numpy(opt_full).to(dev),
        torch.from_numpy(transform_mask).to(dev),
        torch.from_numpy(participates).to(dev))
    n = mdist.all_reduce_sum(int(participates.sum()), group)
    return store.replace(slots=slots, centers=centers, poses=poses), \
        {"n_corrected": n, "n_cells_fused": n_fused}
