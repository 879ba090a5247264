"""Inter-robot submap exchange and joint global fusion.

Counterpart of gem_tpu/multirobot/exchange.py: the per-robot submap rings
of a fleet state (leading robot axis) merge into one joint store and
re-fuse across robots with the single-robot loop-closure machinery, or,
over several processes, with the sharded ring (global_map/sharded.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gem_tpu_torch.global_map import submaps as sm
from gem_tpu_torch.global_map.loop_closure import apply_loop_closure
from gem_tpu_torch.utils.tree import tree_map


def merge_fleet_stores(fleet_submaps: sm.SubmapStore, cfg,
                       max_total: int | None = None,
                       return_mapping: bool = False):
    """Concatenate the per-robot submap rings into one joint store, robot by
    robot, each robot's slots in trajectory order (by keyframe id, so the
    order survives a wrapped ring).  `kf_ids` restart at 0..out, the merged
    order the joint poses are indexed by.

    With `return_mapping` returns (merged, (r_idx, k_idx)): int32 NumPy
    arrays of each merged slot's robot and source slot."""
    R, K = fleet_submaps.counts.shape
    total = max_total or R * K
    dev = fleet_submaps.counts.device
    merged = sm.init_store(cfg.replace(submap=dataclasses.replace(
        cfg.submap, max_submaps=total)), dev)

    ids = fleet_submaps.kf_ids.cpu().numpy()
    sel = []
    for r in range(R):
        occupied = [(int(ids[r, k]), k) for k in range(K) if ids[r, k] >= 0]
        sel.extend((r, k) for _, k in sorted(occupied))
    sel = sel[:total]
    out = len(sel)
    r_np = np.asarray([s[0] for s in sel], np.int32)
    k_np = np.asarray([s[1] for s in sel], np.int32)
    if out == 0:
        return (merged, (r_np, k_np)) if return_mapping else merged
    r_idx = torch.from_numpy(r_np).long().to(dev)
    k_idx = torch.from_numpy(k_np).long().to(dev)

    def put(full, src):
        full = full.clone()
        full[:out] = src[r_idx, k_idx]
        return full

    merged = merged.replace(
        slots=tree_map(put, merged.slots, fleet_submaps.slots),
        counts=put(merged.counts, fleet_submaps.counts),
        centers=put(merged.centers, fleet_submaps.centers),
        poses=put(merged.poses, fleet_submaps.poses),
        num_submaps=torch.full_like(merged.num_submaps, out),
        kf_ids=torch.cat([torch.arange(out, dtype=torch.int32, device=dev),
                          merged.kf_ids[out:]]))
    return (merged, (r_np, k_np)) if return_mapping else merged


def joint_loop_closure(fleet_submaps: sm.SubmapStore, cfg,
                       opt_poses) -> tuple[sm.SubmapStore, dict]:
    """Merge all robots' submaps and re-stitch them with jointly optimised
    poses (indexed by merged order)."""
    merged = merge_fleet_stores(fleet_submaps, cfg)
    joint_cfg = cfg.replace(submap=dataclasses.replace(
        cfg.submap, max_submaps=merged.counts.shape[0]))
    return apply_loop_closure(merged, joint_cfg, opt_poses)
