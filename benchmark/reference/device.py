"""The device an entry point runs on: the card unless the caller asks for the
CPU.

Every entry point of the package (`ElevationPipeline`, `make_fleet_state`,
`synthetic_frames`, `pad_frame`, `load_npz_frame`, `load_checkpoint`,
`load_checkpoint_sharded`, the CLI's `--device`) takes `device="cuda"` by
default and resolves it here: asking for `cuda` on a machine without one is
an error, never a silent CPU run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises RuntimeError for a CUDA device
    when none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run the plain PyTorch versions")
    return dev


def upload(array, device) -> torch.Tensor:
    """A host array (NumPy, nested sequence) as a tensor on `device`.  To a
    card it goes through pinned memory and an asynchronous copy, so the
    upload is no synchronising operation: the step's first call, which
    builds its cached tables, runs under
    `torch.cuda.set_sync_debug_mode("error")`."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


@functools.lru_cache(maxsize=64)
def constant(values: tuple, device: str) -> torch.Tensor:
    """The float32 tensor of the nested tuple `values` on `device`, built
    once per device: a per-frame constant uploaded inside the step would
    be a host-to-device copy in every frame, which a CUDA graph cannot
    hold.  Shared by every caller: never write into it."""
    return upload(np.asarray(values, np.float32), device)
