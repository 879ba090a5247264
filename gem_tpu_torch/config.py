"""The configuration tree, shared with gem_tpu without importing jax.

`gem_tpu/config.py` imports only the standard library; `shared.load` runs
that one file by path (importing it as `gem_tpu.config` would import jax).
Port code duck-types configs (no isinstance checks), so a `gem_tpu.config`
object and one of these classes are interchangeable.
"""

from __future__ import annotations

from gem_tpu_torch.shared import load

_cfg = load("config.py")

PipelineConfig = _cfg.PipelineConfig
MapConfig = _cfg.MapConfig
CameraConfig = _cfg.CameraConfig
SensorConfig = _cfg.SensorConfig
BodyFilterConfig = _cfg.BodyFilterConfig
SubmapConfig = _cfg.SubmapConfig
benchmark_config = _cfg.benchmark_config
kitti_config = _cfg.kitti_config
yq_config = _cfg.yq_config
config_from_yaml = _cfg.config_from_yaml
validate_config = _cfg.validate_config

__all__ = ["PipelineConfig", "MapConfig", "CameraConfig", "SensorConfig",
           "BodyFilterConfig", "SubmapConfig", "benchmark_config",
           "kitti_config", "yq_config", "config_from_yaml",
           "validate_config"]
