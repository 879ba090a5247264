# A copy of gem_tpu/sensors/catalog.py (the port reads nothing under gem_tpu/).
"""Sensor model catalog: calibrated presets for common sensors.

Parameter values match the reference's sensor_processors yaml catalog
(elevation_mapping/config/sensor_processors/*.yaml) with the published
sources they cite (Pomerleau et al. CARPI 2012 for lasers; Nguyen et al.
2012 for structured light; Keller 2014 for the ASLAM stereo rig).
Select with `sensor_preset("velodyne_vlp16")` or via yaml
`sensor: {model: ..., ...}`.
"""

from __future__ import annotations

from gem_tpu_torch.config import SensorConfig

_LASER_POMERLEAU = dict(model="laser", min_radius=0.018, beam_angle=0.0006,
                        beam_constant=0.0015)

SENSOR_PRESETS: dict[str, SensorConfig] = {
    # lasers (one Pomerleau parameterisation covers the catalog's scanners)
    "velodyne": SensorConfig(**_LASER_POMERLEAU),
    "velodyne_hdl32e": SensorConfig(**_LASER_POMERLEAU),
    "velodyne_hdl64e": SensorConfig(**_LASER_POMERLEAU),
    "velodyne_vlp16": SensorConfig(**_LASER_POMERLEAU,
                                   ignore_points_above=0.8,
                                   ignore_points_below=-5.0),
    "hokuyo_utm30lx": SensorConfig(**_LASER_POMERLEAU),
    "pandar_qt": SensorConfig(**_LASER_POMERLEAU,
                              ignore_points_above=0.8,
                              ignore_points_below=-5.0),

    # structured light
    "kinect": SensorConfig(
        model="structured_light", cutoff_min_depth=0.35, cutoff_max_depth=3.0,
        normal_factor_a=0.0012, normal_factor_b=0.0019, normal_factor_c=0.4,
        normal_factor_d=0.0, normal_factor_e=1.0,
        lateral_factor=0.001376915),
    "realsense_zr300": SensorConfig(
        model="structured_light", cutoff_min_depth=0.35, cutoff_max_depth=3.0,
        normal_factor_a=0.00241809, normal_factor_b=0.00662547,
        normal_factor_c=0.77199589, normal_factor_d=0.0, normal_factor_e=1.0,
        lateral_factor=0.00220941),
    "realsense_d435": SensorConfig(
        model="structured_light", cutoff_min_depth=0.2, cutoff_max_depth=3.25,
        normal_factor_a=0.000611, normal_factor_b=0.003587,
        normal_factor_c=0.3515, normal_factor_d=0.0, normal_factor_e=1.0,
        lateral_factor=0.01576),
    "fotonic_g45": SensorConfig(
        model="structured_light", cutoff_min_depth=0.5, cutoff_max_depth=3.25,
        normal_factor_a=0.0263, normal_factor_b=0.0, normal_factor_c=0.0,
        normal_factor_d=0.0, normal_factor_e=1.0, lateral_factor=0.003163),
    "carmine_109": SensorConfig(
        model="structured_light", cutoff_min_depth=0.2, cutoff_max_depth=2.0,
        normal_factor_a=0.000181, normal_factor_b=0.00166,
        normal_factor_c=0.1, normal_factor_d=0.0, normal_factor_e=1.0,
        lateral_factor=0.001376915),

    # stereo
    "aslam_stereo": SensorConfig(
        model="stereo", p_1=0.03287, p_2=-0.0001276, p_3=0.4850,
        p_4=399.1046, p_5=0.000006735, lateral_factor=0.001376915,
        depth_to_disparity_factor=47.3),

    # ground truth
    "perfect": SensorConfig(model="perfect"),
}


def sensor_preset(name: str) -> SensorConfig:
    key = name.lower().replace("-", "_")
    if key not in SENSOR_PRESETS:
        raise KeyError(f"unknown sensor preset {name!r}; options: "
                       f"{sorted(SENSOR_PRESETS)}")
    return SENSOR_PRESETS[key]
