"""The device an entry point runs on: the card unless the caller asks for the
CPU.

Every entry point of the package (`ElevationPipeline`, `make_fleet_state`,
`synthetic_frames`, `pad_frame`, `load_npz_frame`, `load_checkpoint`,
`load_checkpoint_sharded`, the CLI's `--device`) takes `device="cuda"` by
default and resolves it here: asking for `cuda` on a machine without one is
an error, never a silent CPU run.
"""

from __future__ import annotations

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
