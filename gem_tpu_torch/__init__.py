"""gem_tpu_torch — the PyTorch + CUDA port of gem_tpu for NVIDIA Hopper.

The JAX package `gem_tpu` is the reference; this package mirrors its layout
and function names so each module's counterpart is obvious:

    core/        MapState, wrap-around index math, rolling move / re-anchor
    kernels/     point processing (with the `lowest` bound), streaming fuse
                 (CUDA kernel K1), the segment / sort / pallas fuse over
                 scatter.py and segment_stats.py (CUDA kernel K3), plane-fit
                 features (CUDA kernel K2), raytrace cleanup; csrc/ holds the
                 kernels' CUDA C++ sources, kernels/_build.py builds them
    sensors/     the four sensor noise models
    motion/      pose-covariance -> map process noise
    global_map/  the submap store (with the orthomosaic ring), loop
                 closure, voxel pyramid + octomap files, densify, signatures
    mapping/     the per-frame step and ElevationPipeline
    render/      costmaps, inflation, orthomosaic, heatmap, grid cloud
    io/          synthetic and npz replay, npz checkpoints, PCD, KITTI
                 conversion, the CLI (`python -m gem_tpu_torch run`)
    utils/       precision rules, metrics / torch.profiler, PNG writer,
                 CUDA graphs (graph.py: the counterpart of jax.jit)
    native/      the C++ host runtime (voxel filter, cell dedup, file
                 prefetcher), built with g++ into build/gem_tpu_torch/
    config.py, msgs.py  the configuration tree and the record types

config, msgs, io/pcd, io/kitti, utils/image, sensors/catalog,
global_map/octomap_io and native are copies of gem_tpu's JAX-free modules:
the port reads nothing under gem_tpu/.

State is frozen dataclasses of tensors, functions are plain tensor code, and
every constructor takes an explicit `device`.  On CPU tensors each kernel
wrapper runs its plain PyTorch version; on CUDA tensors it launches the
hand-written kernel.  The step reads nothing to the host, and on the card
ElevationPipeline and the fleet replay it as CUDA graphs.  The top-level
names are those `gem_tpu` exports.  This package never imports jax.
"""

import torch

# Exact fp32 everywhere the JAX package forces Precision.HIGHEST
# (gem_tpu/utils/precision.py): the sensor->map transform carries +-40 m
# coordinates, and TF32's 10-bit mantissa would cost centimetres.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from gem_tpu_torch.config import (  # noqa: F401,E402
    MapConfig,
    SensorConfig,
    RobotConfig,
    PipelineConfig,
    kitti_config,
    yq_config,
    benchmark_config,
)
from gem_tpu_torch.core.state import (  # noqa: E402,F401
    MapState, init_map_state)


def __getattr__(name):  # lazy: keep `import gem_tpu_torch` light
    if name in ("ElevationPipeline", "Frame", "PipelineState", "step"):
        from gem_tpu_torch.mapping import pipeline as _p

        return getattr(_p, name)
    raise AttributeError(name)
