"""Checkpoint / resume: the full PipelineState to npz and back.

Counterpart of gem_tpu/io/checkpoint.py in its npz schema: one array per
leaf, keyed by the dataclass field path ("map/elevation",
"submaps/slots/x", "frame_idx", ...), extras under "__extra__/<name>".  The
field names of the two packages are the same, so a checkpoint written by
either loads in the other: this is the state hand-over beside
`state_from_numpy`.  Orbax checkpoints (sharded fleet states) wait for the
port of multirobot/.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from gem_tpu_torch.mapping.pipeline import PipelineState, init_pipeline_state
from gem_tpu_torch.utils.device import resolve_device
from gem_tpu_torch.utils.tree import tree_leaves

# Leaves that may legitimately be absent from older checkpoints (added after
# the npz schema shipped) and whose init values are safe substitutes.  Any
# OTHER missing leaf is an error: a truncated or corrupted npz, or a renamed
# field, must not load silently with zeroed state.
_OPTIONAL_LEAF_TOKENS = ("staging", "kf_ids")


def _flatten(obj) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree_leaves(obj).items()}


def _rebuild(template, leaves: dict, device, prefix: str = ""):
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        key = prefix + f.name
        kw[f.name] = (_rebuild(v, leaves, device, key + "/")
                      if dataclasses.is_dataclass(v)
                      else torch.from_numpy(np.array(leaves[key])).to(device))
    return type(template)(**kw)


def save_checkpoint(path: str, state: PipelineState,
                    extra: dict | None = None):
    flat = _flatten(state)
    for k, v in (extra or {}).items():
        flat[f"__extra__/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_checkpoint(path: str, cfg, device="cuda"
                    ) -> tuple[PipelineState, dict]:
    """Rebuild a PipelineState on `device` (template from cfg) plus any
    extras."""
    device = resolve_device(device)
    data = np.load(path)
    template = init_pipeline_state(cfg, "cpu")
    leaves = _flatten(template)
    substituted = []
    for key in leaves:
        if key in data:
            leaves[key] = data[key]
        elif any(tok in key for tok in _OPTIONAL_LEAF_TOKENS):
            substituted.append(key)     # forward compat: keep the init value
        else:
            raise KeyError(
                f"checkpoint {path!r} is missing required leaf {key!r} "
                f"(truncated/corrupted file, or a config whose state shapes "
                f"don't match the save?)")
    if substituted:
        warnings.warn(f"checkpoint {path!r} predates leaves {substituted}; "
                      f"substituted init values")
        if any(k.endswith("kf_ids") for k in substituted):
            leaves["submaps/kf_ids"] = _reconstruct_kf_ids(
                int(leaves["submaps/num_submaps"]),
                leaves["submaps/counts"].shape[0])
    state = _rebuild(template, leaves, device)
    extra = {k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith("__extra__/")}
    return state, extra


def _reconstruct_kf_ids(num: int, K: int):
    """Old checkpoints predate SubmapStore.kf_ids; rebuild the ids from the
    ring arithmetic: slot s last held keyframe num - 1 - ((num - 1 - s) mod
    K) (negative => never written)."""
    s = np.arange(K)
    ids = num - 1 - ((num - 1 - s) % K) if num > 0 else np.full(K, -1)
    return np.where(ids >= 0, ids, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Sharded fleet states: torch.distributed.checkpoint, one shard per rank.


def _shard_prefix(robots: range) -> str:
    return f"robots_{robots.start}-{robots.stop}/"


def save_checkpoint_sharded(directory: str, state: PipelineState,
                            robots: range | None = None,
                            group=None) -> None:
    """Write this rank's fleet state (leading robot axis) into `directory`
    with torch.distributed.checkpoint, every rank its own robots.  The keys
    carry the robot range (`robots`, by default this rank's even share of
    all ranks' robots), so each rank's tensors are distinct entries: DCP
    would take equal keys for one replicated tensor and keep one rank's
    copy.  Without a process group it writes one shard."""
    import torch.distributed.checkpoint as dcp

    from gem_tpu_torch.multirobot import distributed as mdist

    if robots is None:
        n = state.frame_idx.shape[0]
        robots = mdist.local_robots(n * mdist.rank_and_size(group)[1], group)
    prefix = _shard_prefix(robots)
    flat = {prefix + k: v for k, v in tree_leaves(state).items()
            if v.numel()}
    dcp.save(flat, checkpoint_id=directory, process_group=group,
             no_dist=not torch.distributed.is_initialized())


def load_checkpoint_sharded(directory: str, cfg, robots: range,
                            device="cuda", group=None) -> PipelineState:
    """Restore the robots `robots` of a `save_checkpoint_sharded` directory
    into a fleet template built from `fleet_effective_config(cfg)` on
    `device`; `robots` must be a range one rank saved."""
    import torch.distributed.checkpoint as dcp

    from gem_tpu_torch.multirobot.fleet import make_fleet_state

    state = make_fleet_state(cfg, len(robots), device)
    prefix = _shard_prefix(robots)
    flat = {prefix + k: v for k, v in tree_leaves(state).items()
            if v.numel()}
    dcp.load(flat, checkpoint_id=directory, process_group=group,
             no_dist=not torch.distributed.is_initialized())
    return state
