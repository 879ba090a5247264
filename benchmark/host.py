"""The host side of a run kept steady: one process on one core.

The card's machine shares its host's cores, and a run's host work (the
pipeline's per-call copies, the intake's voxel filter, the re-stitch's pair
selection) moved by a third between runs that the scheduler spread over
all cores.  `pin_one_core` binds the process, and every thread it starts
later, to the last core it may use; called before torch is imported.
Neither the main thread alone on that core with the other threads on the
rest, nor no binding with one thread per library, ran steadier."""

import os


def pin_one_core() -> int:
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core
