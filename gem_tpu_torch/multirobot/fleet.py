"""Multi-robot scale-out: the pipeline over a leading robot axis.

Counterpart of gem_tpu/multirobot/fleet.py.  A fleet state is the
single-robot `PipelineState` with a leading robot axis on every leaf, the
same tree as the JAX package's, so `state_from_numpy` / `state_to_numpy`
carry a JAX fleet state across unchanged.

JAX's `fleet_step` is `jax.vmap` of `step`, and `FleetPipeline` replays
it as `jax.jit(fleet_step)`.  Here `fleet_step` runs each robot's `step`
on views of the stacked state, so on the card that is K1 and K2 (stream)
or 5 x K3 and K2 (pallas) once per robot and frame; the kernels take no
robot axis yet.  `step` reads nothing to the host, so `FleetPipeline`
captures the whole fleet frame, every robot's step and its write-back,
as one CUDA graph (utils/graph.py).

`step` consumes its state: the submap rings update in place, which writes
through the views into the stack; every leaf that `step` replaces instead
is copied back into the stack (`write_back`).

JAX's mesh functions (`make_mesh`, `shard_fleet`, `sharded_fleet_step`) have
their counterparts in multirobot/distributed.py: one process per card,
each running `fleet_step` on its own robots with no collective.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gem_tpu_torch.mapping.pipeline import (PipelineState,
                                            init_pipeline_state,
                                            stack_frames,  # noqa: F401
                                            step)
from gem_tpu_torch.utils.device import resolve_device
from gem_tpu_torch.utils.graph import DeviceProgram, write_back
from gem_tpu_torch.utils.tree import tree_map


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
        write_back(views, new)
        outs.append(out)
    return state, tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


class FleetPipeline:
    """A fleet's stacked state and its step, as `ElevationPipeline` is for
    one robot: on the card `process` replays `fleet_step` as one CUDA
    graph per fleet frame (the counterpart of `jax.jit(fleet_step)`), on
    the CPU it calls it.  `state` is the live stacked state, overwritten
    by the next call; assigning it copies a state in."""

    def __init__(self, cfg, n_robots: int, device="cuda",
                 fuse_backend: str = "stream"):
        self.cfg = cfg
        self._program = DeviceProgram(make_fleet_state(cfg, n_robots,
                                                       device))
        self._step = functools.partial(fleet_step, cfg=cfg,
                                       fuse_backend=fuse_backend)

    @property
    def state(self) -> PipelineState:
        return self._program.state

    @state.setter
    def state(self, state: PipelineState) -> None:
        self._program.state = state

    def process(self, frames):
        """One frame for every robot (`frames` stacked on a leading robot
        axis); returns the robots' StepOutputs, stacked."""
        return self._program(self._step, frames)
