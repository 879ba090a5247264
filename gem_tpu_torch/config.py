"""The configuration tree, shared with gem_tpu without importing jax.

`gem_tpu/config.py` imports only the standard library, but importing it as
`gem_tpu.config` runs `gem_tpu/__init__.py`, which imports jax.  So this
module loads that one file by path: one source of truth, no copy.  Port code
duck-types configs (no isinstance checks), so a `gem_tpu.config` object and
one of these classes are interchangeable.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_NAME = "gem_tpu_torch._shared_config"
_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gem_tpu", "config.py")

if _NAME in sys.modules:
    _cfg = sys.modules[_NAME]
else:
    _spec = importlib.util.spec_from_file_location(_NAME, _PATH)
    _cfg = importlib.util.module_from_spec(_spec)
    # registered before exec: dataclasses resolves the module by name
    sys.modules[_NAME] = _cfg
    _spec.loader.exec_module(_cfg)

PipelineConfig = _cfg.PipelineConfig
MapConfig = _cfg.MapConfig
benchmark_config = _cfg.benchmark_config
kitti_config = _cfg.kitti_config
validate_config = _cfg.validate_config

__all__ = ["PipelineConfig", "MapConfig", "benchmark_config",
           "kitti_config", "validate_config"]
