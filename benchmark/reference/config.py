# A copy of gem_tpu/config.py (the port reads nothing under gem_tpu/).
"""Frozen, hashable configuration tree.

The reference scatters ~25 rosparams across yaml files read imperatively in
`readParameters()` (reference: src/ElevationMapping.cpp:137-220,
sensor_processors/*.cpp readParameters, RobotMotionMapUpdater.cpp:36-40) plus a
camera-intrinsics OpenCV yaml re-read every frame (src/ElevationMapping.cpp:331-340).
Here the whole tree is frozen dataclasses: hashable (so configs can be static
args to jit) and loadable from a single yaml/dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["PipelineConfig", "MapConfig", "CameraConfig", "SensorConfig",
           "BodyFilterConfig", "SubmapConfig", "benchmark_config",
           "kitti_config", "yq_config", "config_from_yaml",
           "validate_config"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Sensor noise model parameters.

    The reference defines four models (selected by `sensor_processor/type`,
    reference: src/ElevationMapping.cpp:203-214) but its CUDA path implements
    only the laser model regardless of subclass (gpu_process.cu:410-411).  Here
    all four are real (see sensors/models.py):

      - laser:   sigma_n = min_radius; sigma_l = beam_constant + beam_angle * d
                 (Pomerleau et al., CARPI 2012; LaserSensorProcessor.cpp:20-27)
      - structured_light: Nguyen et al. 2012 depth-squared model
                 (StructuredLightSensorProcessor.cpp:21-24, 132-140)
      - stereo:  disparity model (StereoSensorProcessor.cpp:85-92)
      - perfect: zero noise (PerfectSensorProcessor.cpp:88-92)
    """

    model: str = "laser"  # laser | structured_light | stereo | perfect

    # laser (velodyne.yaml defaults)
    min_radius: float = 0.018
    beam_angle: float = 0.0006
    beam_constant: float = 0.0015

    # structured light (kinect_nguyen_et_al.yaml defaults)
    normal_factor_a: float = 0.0012
    normal_factor_b: float = 0.0019
    normal_factor_c: float = 0.4
    normal_factor_d: float = 0.0
    normal_factor_e: float = 1.0
    lateral_factor: float = 0.001376915
    cutoff_min_depth: float = 0.35
    cutoff_max_depth: float = 3.0

    # stereo
    p_1: float = 0.0
    p_2: float = 0.0
    p_3: float = 0.0
    p_4: float = 0.0
    p_5: float = 0.0
    depth_to_disparity_factor: float = 0.0
    stereo_center_u: float = 320.0
    stereo_center_v: float = 240.0

    # height band relative to robot base
    # (SensorProcessorBase.cpp:183-184: threshold = base_z + ignore_*)
    ignore_points_above: float = float("inf")
    ignore_points_below: float = float("-inf")


@dataclasses.dataclass(frozen=True)
class BodyFilterConfig:
    """Sensor-frame self/FOV filter applied per point.

    `reference` mode replicates the hard-coded box in G_pointsprocess
    (gpu_process.cu:393): drop when
        (|x|<1.5 and |y|<1.5) or (|y|<1) or (y>0).
    `box` drops only the body box; `none` keeps everything.
    """

    mode: str = "reference"  # reference | box | none
    body_half_x: float = 1.5
    body_half_y: float = 1.5


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Rolling local elevation grid geometry + fusion constants.

    Mirrors config/elevation_maps/*.yaml of the reference (kitti: 15 m @ 0.2 m
    => 75x75; yq: 12 m @ 0.1 m => 120x120).
    """

    length: int = 75              # cells per side (length_in_x / resolution)
    resolution: float = 0.2       # m / cell
    min_variance: float = 1.0e-4  # kitti_demo_map.yaml:9; gpu_process.cu:500,533
    max_variance: float = 1.0e4   # accepted for yaml parity; the reference
    # kernels never consult it (upstream-only parameter)
    mahalanobis_threshold: float = 5.0  # gpu_process.cu:504 hardcodes 5 and
    # ignores the yaml value (2.5); default keeps kernel behavior.
    multi_height_noise: float = 2.0e-5  # yaml parity; unused by the
    # reference CUDA path (upstream-only)
    obstacle_threshold: float = 0.7     # traver below this => raytrace candidate
    # (src/ElevationMapping.cpp:199 passes 0.7 regardless of travers_threshold)

    # sentinels (gpu_process.cu:198-239)
    invalid_elevation: float = -10.0
    invalid_variance: float = -10.0
    invalid_traversability: float = -10.0
    lowest_init: float = 100.0   # G_Init_map
    lowest_reset: float = 10.0   # G_Clear_maplowest after every raytrace pass

    # feature stencil (G_Mapfeature, gpu_process.cu:549-670)
    feature_min_neighbors: int = 8
    slope_critical: float = 0.6
    rough_critical: float = 0.2

    # raytrace discretisation (kernels/raytrace.py); rays default to ~3 per
    # boundary cell when <= 0.  raytrace_group = radial cells per
    # "strictly farther" granule along a ray (the nearest group-1 ray-mates
    # never delete an obstacle — conservative).  num_steps parametrises the
    # round-1 radial-step-table formulation (superseded; accepted for yaml
    # compatibility).
    raytrace_num_rays: int = 0
    raytrace_num_steps: int = 0
    raytrace_group: int = 0     # 0 => max(2, length // 250)
    # Far-field constraint pooling (kernels/raytrace.py): p > 1 min-pools
    # the per-cell constraint field g p x p BEFORE the ray partition, so
    # the two slot sorts shrink p^2 while every constraint VALUE stays
    # exact (min-pool commutes with the suffix min); only the "strictly
    # farther" exclusion coarsens to ~p*group cells — conservative, same
    # class as the group-granule deviation (PARITY.md).  0 => auto: 3 for
    # length >= 768 (round-3 on-chip knee, 99.4% deletion agreement at
    # L=1000), 2 for length >= 512, else 1 (small maps stay exact).
    raytrace_far_pool: int = 0

    # rolling-buffer shift cap per frame (cells).  Shifts beyond this fall back
    # to a full-map clear, like indexShift >= length in Move (gpu_process.cu:1033).
    max_shift_cells: int = 32

    def num_rays(self) -> int:
        # 3 rays/boundary cell: with the square-angle partition the line
        # corridor at the rim stays within ~0.5-0.9 cells of the reference
        # DDA's; the padded slot count is capped by the exact-axis rays
        # (~L/2 cells each), so fewer rays shrink the raytrace sorts
        # linearly (kernels/raytrace.py)
        if self.raytrace_num_rays > 0:
            return self.raytrace_num_rays
        return _round_up(3 * self.length, 128)

    def num_steps(self) -> int:
        if self.raytrace_num_steps > 0:
            return self.raytrace_num_steps
        return _round_up(int(math.ceil(self.length * 0.75)), 8)


@dataclasses.dataclass(frozen=True)
class SubmapConfig:
    """Fixed-capacity submap store (global_map/submaps.py).

    The reference sheds exiting cells into an unordered_map and pushes
    point-cloud submaps onto an unbounded vector (src/ElevationMapping.cpp:609-710,
    globalMap_ stack).  TPU-native: a ring of K submap slots, each a fixed
    (capacity, fields) tensor with a write cursor; appends are masked
    dynamic-slice writes, never reallocation.
    """

    max_submaps: int = 64
    capacity: int = 32768          # points per submap slot
    keyframe_distance: float = 10.0  # robot_local_map_size (kitti_demo_robot.yaml)
    overlap_radius: float = 25.0     # loop-closure kd radius (ElevationMapping.cpp:834)
    dedup_cell_quantum: float = 0.0  # 0 => use map resolution
    # Published SubMap payload (dislam_msgs/SubMap.msg: orthoImage +
    # keyframePC, attached at src/ElevationMapping.cpp:666-681).  store_ortho
    # keeps a per-keyframe (L, L, 3) orthomosaic snapshot ring;
    # keyframe_scan_points > 0 keeps that many (subsampled) raw sensor-frame
    # points of the keyframe-triggering scan.  0 / False disable the rings
    # (e.g. the 1000x1000 benchmark config, where the ortho ring alone would
    # be 192 MB).
    store_ortho: bool = True
    keyframe_scan_points: int = 4096
    # Loop-closure re-fusion work bound: each submap re-fuses with at most
    # its M nearest overlapping neighbours (the reference's kd radius query
    # is unbounded, src/ElevationMapping.cpp:834 — O(K^2) pairs in dense
    # rings).  Independent pairs are batched into vertex-disjoint rounds,
    # so the device-serial chain length is O(M), not O(K^2).
    max_pairs_per_submap: int = 8
    # Deferred shed compaction: stage up to this many raw per-frame shed
    # bands in a (S, band) ring (one dynamic-update-slice per frame) and
    # cumsum-compact them into the accumulator only when the ring fills or
    # a keyframe finalizes.  Semantically identical to per-frame compaction
    # (the accumulator is only consumed at finalize; staged bands flush in
    # frame order), but amortizes the per-frame stack+scatter glue measured
    # at 1.27 ms/frame on the 1M-point step (bench/results/PROFILE_r3.md).
    # 0 = compact every frame.  Keep 0 for vmap'd fleets: under vmap the
    # flush lax.cond lowers to a select that pays the flush EVERY frame
    # (multirobot/fleet.py forces 0 for this reason).
    # Default 32 (round-4 on-chip A/B at the strict 1M row: 14.96 ms vs
    # 15.56 at 8, back-to-back) — a deeper ring amortizes
    # the flush further at ~(ring depth x band) extra HBM, with the
    # flush spike every 32nd frame instead of every 8th.
    staging_frames: int = 32


@dataclasses.dataclass(frozen=True)
class PreFilterConfig:
    """Host-side voxel-grid pre-filter, the reference's filter chains
    (filter_kitti.launch: leaf 0.2 m, crop x/y ±40 m z ±25 m;
    filter.launch: leaf 0.1 m, x ±10 m).  leaf <= 0 disables.  Runs in the
    native C++ loader (native/) before padding."""

    leaf: float = 0.0
    crop_x: Tuple[float, float] = (-1e9, 1e9)
    crop_y: Tuple[float, float] = (-1e9, 1e9)
    crop_z: Tuple[float, float] = (-1e9, 1e9)


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    covariance_scale: float = 1.0
    ignore_robot_motion_updates: bool = False


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics+extrinsics for point colorization.

    Replaces the per-frame OpenCV yaml re-read (src/ElevationMapping.cpp:331-340)
    with a static (3,4) lidar->image projection provided once.
    """

    image_height: int = 0
    image_width: int = 0
    # Row-major 3x4 projection P = T_camera(3x4) @ T_lidar(4x4); 0-size image
    # disables colorization.
    projection: Tuple[float, ...] = tuple([0.0] * 12)


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    robot_id: int = 0
    robot_name: str = "robot0"
    track_point: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config: everything the jitted step needs, hashable."""

    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    body_filter: BodyFilterConfig = dataclasses.field(default_factory=BodyFilterConfig)
    submap: SubmapConfig = dataclasses.field(default_factory=SubmapConfig)
    prefilter: PreFilterConfig = dataclasses.field(
        default_factory=PreFilterConfig)
    motion: MotionConfig = dataclasses.field(default_factory=MotionConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    robot: RobotConfig = dataclasses.field(default_factory=RobotConfig)

    max_points: int = 32768   # padded point budget per frame
    traversability_threshold: float = 0.8  # travers_threshold (costmap/octomap split)
    enable_raytrace: bool = True
    # run the visibility cleanup every Nth frame (the reference schedules it
    # at ~1 Hz vs the 10 Hz callback, README.md:284-287); 1 = every frame
    raytrace_every: int = 1
    enable_features: bool = True
    # ablation gates for the timing probe (bench/probe.py): disable the
    # submap shed/keyframe path or the lowest-scan tracking to attribute
    # step time by difference-of-full-programs.  Production configs keep
    # both True.
    enable_submaps: bool = True
    enable_lowest: bool = True
    # False statically strips the color/intensity fuse machinery for
    # colorless (camera-less) deployments — faithful: the reference's color
    # gate (r*g*b != 0 & intensity != 0, gpu_process.cu:488) never fires
    # without colors, so the planes are untouched either way.
    enable_color: bool = True
    # odometry-jump handling (src/ElevationMapping.cpp:987-993): consecutive
    # frames with |dz| <= jump_z_tolerance needed to declare the jump settled.
    jump_z_tolerance: float = 0.02
    jump_settle_count: int = 3

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def validate_config(cfg: "PipelineConfig") -> None:
    """Reject configurations that would silently degenerate.

    The published stereo model (StereoSensorProcessor.cpp:85-92) needs
    per-point pixel coordinates; without a camera the image-plane term would
    collapse to the principal point.  Users selecting stereo must configure
    the camera (round-1 verdict: no silent fallback)."""
    if cfg.sensor.model == "stereo" and cfg.camera.image_height <= 0:
        raise ValueError(
            "sensor.model='stereo' requires a camera configuration "
            "(camera.image_height/image_width + projection): the stereo "
            "variance model's image-plane term needs per-point pixel "
            "coordinates (StereoSensorProcessor.cpp:85-92). Configure the "
            "camera or choose another sensor model.")
    if cfg.sensor.model not in ("laser", "structured_light", "stereo",
                                "perfect"):
        raise ValueError(f"unknown sensor model {cfg.sensor.model!r}")
    p = cfg.map.raytrace_far_pool
    if p < 0:
        raise ValueError("map.raytrace_far_pool must be >= 0 (0 = auto)")
    if p > 1 and cfg.map.length // p < 64:
        raise ValueError(
            f"map.raytrace_far_pool={p} leaves a {cfg.map.length // p}^2 "
            "pooled constraint grid — below 64^2 the pooled granule spans "
            "a large fraction of the map radius and cleanup efficacy "
            "collapses (measured: 21% of deletions lost at 32^2-equivalent "
            "granularity). Use a smaller pool or 0 (auto).")


# ---------------------------------------------------------------------------
# yaml/dict loading


def _build(cls, data: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        field = fields[key]
        nested = None
        if field.default_factory is not dataclasses.MISSING:
            proto = field.default_factory()
            if dataclasses.is_dataclass(proto):
                nested = type(proto)
        if nested is not None and isinstance(value, dict):
            kwargs[key] = _build(nested, value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def config_from_dict(data: dict) -> PipelineConfig:
    return _build(PipelineConfig, data)


def config_from_yaml(path: str) -> PipelineConfig:
    import yaml

    with open(path) as f:
        return config_from_dict(yaml.safe_load(f) or {})


# Canonical operating points from the reference demos.

def kitti_config(**overrides) -> PipelineConfig:
    """KITTI demo: 15x15 m @ 0.2 m (kitti_demo_map.yaml)."""
    cfg = PipelineConfig(
        map=MapConfig(length=75, resolution=0.2),
        sensor=SensorConfig(model="laser", ignore_points_above=0.8,
                            ignore_points_below=-5.0),
        prefilter=PreFilterConfig(leaf=0.2, crop_x=(-40.0, 40.0),
                                  crop_y=(-40.0, 40.0),
                                  crop_z=(-25.0, 25.0)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def yq_config(**overrides) -> PipelineConfig:
    """YQ / PandarQT demo: 12x12 m @ 0.1 m (simple_demo_map.yaml)."""
    cfg = PipelineConfig(
        map=MapConfig(length=120, resolution=0.1),
        sensor=SensorConfig(model="laser", ignore_points_above=0.8,
                            ignore_points_below=-5.0),
        prefilter=PreFilterConfig(leaf=0.1, crop_x=(-10.0, 10.0)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def benchmark_config(length: int = 1000, **overrides) -> PipelineConfig:
    """North-star benchmark operating point: 1000x1000 cells."""
    cfg = PipelineConfig(
        map=MapConfig(length=length, resolution=0.1, max_shift_cells=32),
        sensor=SensorConfig(model="laser"),
        submap=SubmapConfig(store_ortho=False, keyframe_scan_points=0),
        max_points=131072,
    )
    return cfg.replace(**overrides) if overrides else cfg
