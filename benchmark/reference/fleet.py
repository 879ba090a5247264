"""The reference of a fleet: each robot stepped alone.

A fleet runs one step over a leading robot axis, and robot r's result must
be what robot r gives alone.  So the reference never batches the robots:
it takes robot r's slice of a stacked state (the program's own snapshot, or
a fresh state) and steps it with `pipeline.step` on robot r's frame, with
shed staging off, as a fleet runs.  It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

from benchmark.reference import pipeline
from benchmark.reference.tree import tree_map


def fleet_config(cfg):
    """`cfg` with shed staging off: the configuration every fleet runs
    (the program's `fleet_effective_config`); works on the program's
    config and on the reference's alike."""
    if not cfg.submap.staging_frames:
        return cfg
    return cfg.replace(submap=dataclasses.replace(cfg.submap,
                                                  staging_frames=0))


def robot(tree, r: int):
    """Robot r's slice of a tree stacked over the robots (any dataclasses,
    host or device leaves)."""
    return tree_map(lambda x: x[r], tree)


def init_fleet(cfg, n_robots: int, device) -> list:
    """Each robot's fresh state."""
    return [pipeline.init_pipeline_state(fleet_config(cfg), device)
            for _ in range(n_robots)]


def step(states: list, frames: list, cfg) -> tuple[list, list]:
    """One fleet frame: robot r's state and outputs from `states[r]` and
    `frames[r]` alone.  The states are consumed, as `pipeline.step`'s."""
    cfg = fleet_config(cfg)
    done = [pipeline.step(s, f, cfg) for s, f in zip(states, frames)]
    return [s for s, _ in done], [o for _, o in done]
