"""Multi-robot scale-out: the pipeline over a leading robot axis.

Counterpart of gem_tpu/multirobot/fleet.py.  A fleet state is the
single-robot `PipelineState` with a leading robot axis on every leaf, the
same tree as the JAX package's, so `state_from_numpy` / `state_to_numpy`
carry a JAX fleet state across unchanged.

JAX's `fleet_step` is `jax.vmap` of `step`, and `FleetPipeline` replays
it as `jax.jit(fleet_step)`.  Here `fleet_step` is one call of the step
over the leading robot axis (mapping/pipeline.py `batched_step`, of which
the single-robot `step` is the R = 1 case): every stage runs once for all
robots, and on the card each kernel launches once per fleet frame with the
robots as a grid axis, K1 and K2 (stream) or 5 x K3 and K2 (pallas).  It
reads nothing to the host, so `FleetPipeline` captures the fleet frame as
one CUDA graph (utils/graph.py).

JAX's fleet runs `step`'s defaults, the segment fuse and (on the CPU) the
XLA features; the port's fleet defaults to the stream fuse (K1) and K2.

JAX's mesh functions (`make_mesh`, `shard_fleet`, `sharded_fleet_step`) have
their counterparts in multirobot/distributed.py: one process per card,
each running `fleet_step` on its own robots with no collective.
"""

from __future__ import annotations

import dataclasses
import functools

from gem_tpu_torch.mapping.pipeline import (PipelineState, batched_step,
                                            init_pipeline_state,
                                            stack_frames)  # noqa: F401
from gem_tpu_torch.utils.device import resolve_device
from gem_tpu_torch.utils.graph import DeviceProgram
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
    axis, and the step runs once over it.  Robot r's result is exactly what
    `step` gives for robot r alone.  `state` is consumed (its submap rings
    update in place); returns the new stacked state and the robots'
    StepOutputs, stacked."""
    return batched_step(state, frames, fleet_effective_config(cfg),
                        fuse_backend)


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
