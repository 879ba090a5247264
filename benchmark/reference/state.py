"""MapState: the rolling elevation grid as a frozen dataclass of tensors.

Counterpart of gem_tpu/core/state.py, with the same planes and sentinels:

  elevation  f32  fused surface height; -10 = empty
  variance   f32  height variance; -10 = empty (>=1e-4 once fused)
  intensity  f32  LiDAR intensity; 0 = none
  lowest     f32  lowest scan bound min(h+3*var); 100 init / 10 after clear
                  (GEOGRAPHIC-indexed, unlike every other plane)
  traver     f32  traversability in ~[0,1]; -10 = unknown
  color      i32  packed 0xRRGGBB

Scalars:
  start      i32 (2,)  circular-buffer rotation (storage = geo + start mod L)
  center     f32 (2,)  world position of the window center
  sensor_z   f32 ()    sensor height at the latest move

A fleet's state carries a leading robot axis on every leaf: planes
(R, L, L), `start` and `center` (R, 2), `sensor_z` (R,).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MapState:
    elevation: torch.Tensor
    variance: torch.Tensor
    intensity: torch.Tensor
    lowest: torch.Tensor
    traver: torch.Tensor
    color: torch.Tensor
    start: torch.Tensor
    center: torch.Tensor
    sensor_z: torch.Tensor

    @property
    def length(self) -> int:
        return self.elevation.shape[-1]

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)


def init_map_state(cfg, device, center_xy=(0.0, 0.0)) -> MapState:
    """Fresh empty map (`cfg` is a MapConfig)."""
    L = cfg.length
    f = lambda v: torch.full((L, L), v, dtype=torch.float32, device=device)
    return MapState(
        elevation=f(cfg.invalid_elevation),
        variance=f(cfg.invalid_variance),
        intensity=f(0.0),
        lowest=f(cfg.lowest_init),
        traver=f(cfg.invalid_traversability),
        color=torch.zeros((L, L), dtype=torch.int32, device=device),
        start=torch.zeros((2,), dtype=torch.int32, device=device),
        center=torch.tensor(center_xy, dtype=torch.float32, device=device),
        sensor_z=torch.zeros((), dtype=torch.float32, device=device),
    )


def pack_rgb(r, g, b):
    """Pack 8-bit channels into one int32 plane."""
    r, g, b = (x.to(torch.int32) for x in (r, g, b))
    return (r << 16) | (g << 8) | b


def unpack_rgb(c):
    c = c.to(torch.int32)
    return (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF
