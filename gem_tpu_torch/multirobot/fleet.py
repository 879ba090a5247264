"""Multi-robot scale-out: the pipeline over a leading robot axis.

Counterpart of gem_tpu/multirobot/fleet.py.  A fleet state is the
single-robot `PipelineState` with a leading robot axis on every leaf, the
same tree as the JAX package's, so `state_from_numpy` / `state_to_numpy`
carry a JAX fleet state across unchanged.

JAX's `fleet_step` is `jax.vmap` of `step`.  The port's `step` reads its
branch predicates to the host once per frame, and those branches differ
robot by robot, so it cannot be vmapped: `fleet_step` runs each robot's
`step` on views of the stacked state.  On the card that is K1 and K2
(stream) or 5 x K3 and K2 (pallas) once per robot and frame.

`step` consumes its state: the submap rings update in place, which writes
through the views into the stack; every leaf that `step` replaces instead
is copied back into the stack.

JAX's mesh functions (`make_mesh`, `shard_fleet`, `sharded_fleet_step`) have
their counterparts in multirobot/distributed.py: one process per card,
each running `fleet_step` on its own robots with no collective.
"""

from __future__ import annotations

import dataclasses

import torch

from gem_tpu_torch.mapping.pipeline import (PipelineState,
                                            init_pipeline_state, step)
from gem_tpu_torch.utils.device import resolve_device
from gem_tpu_torch.utils.tree import tree_leaves, tree_map


def fleet_effective_config(cfg):
    """The config that describes a fleet state's shapes: shed staging is
    forced off, as in the JAX package (where a vmapped staging flush would
    run on every frame).  Any template built for a fleet state (checkpoint
    restore included) must come from this config."""
    if cfg.submap.staging_frames:
        cfg = cfg.replace(submap=dataclasses.replace(cfg.submap,
                                                     staging_frames=0))
    return cfg


def make_fleet_state(cfg, n_robots: int, device="cuda") -> PipelineState:
    """Stacked pipeline state with a leading robot axis, shapes described by
    `fleet_effective_config(cfg)`."""
    one = init_pipeline_state(fleet_effective_config(cfg),
                              resolve_device(device))
    return tree_map(lambda x: x.unsqueeze(0).repeat(
        (n_robots,) + (1,) * x.dim()), one)


def stack_frames(frames):
    """One Frame with a leading robot axis from a list of Frames; an
    optional field (image, loop_closure) is None in all of them or in
    none."""
    return tree_map(lambda *xs: torch.stack(xs), frames[0], *frames[1:])


def _write_back(views, new):
    """Copy every leaf of `new` that is not already the view it replaces
    into that view."""
    got = tree_leaves(new)
    for key, dst in tree_leaves(views).items():
        src = got[key]
        if src.data_ptr() != dst.data_ptr():   # replaced, not updated in place
            dst.copy_(src)


def fleet_step(state: PipelineState, frames, cfg,
               fuse_backend: str = "stream"):
    """One frame for every robot: `state` and `frames` carry a leading robot
    axis.  Robot r's result is exactly what `step` gives for robot r alone.
    The stacked `state` is updated in place and returned, with the robots'
    StepOutputs stacked."""
    outs = []
    for r in range(state.frame_idx.shape[0]):
        views = tree_map(lambda x: x[r], state)
        new, out = step(views, tree_map(lambda x: x[r], frames), cfg,
                        fuse_backend)
        _write_back(views, new)
        outs.append(out)
    return state, tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])
