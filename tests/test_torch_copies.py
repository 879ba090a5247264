"""The port's copies of gem_tpu's JAX-free modules against the originals.

`gem_tpu_torch` keeps its own config, msgs, io/pcd, io/kitti, utils/image,
sensors/catalog, global_map/octomap_io and native runtime, and reads nothing
under gem_tpu/.  Each copy must behave as the original: equal configs,
records that cross between the packages, byte-identical files, and equal
results from the two native libraries (each package builds its own).
"""

import dataclasses
import os

import numpy as np
import pytest

from gem_tpu import config as jcfg
from gem_tpu import msgs as jmsgs
from gem_tpu import native as jnative
from gem_tpu.global_map import octomap_io as joct
from gem_tpu.io import kitti as jkitti
from gem_tpu.io import pcd as jpcd
from gem_tpu.sensors import catalog as jcat
from gem_tpu.utils import image as jimage

from gem_tpu_torch import config as tcfg
from gem_tpu_torch import msgs as tmsgs
from gem_tpu_torch import native as tnative
from gem_tpu_torch.global_map import octomap_io as toct
from gem_tpu_torch.io import kitti as tkitti
from gem_tpu_torch.io import pcd as tpcd
from gem_tpu_torch.sensors import catalog as tcat
from gem_tpu_torch.utils import image as timage

_YAML = """\
map:
  length: 128
  resolution: 0.15
  max_shift_cells: 16
sensor:
  model: structured_light
  ignore_points_above: 1.5
prefilter:
  leaf: 0.1
  crop_x: [-12.0, 12.0]
submap:
  max_submaps: 8
max_points: 20000
"""


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# --- config ---------------------------------------------------------------


@pytest.mark.parametrize("preset", ["benchmark_config", "kitti_config",
                                    "yq_config", "PipelineConfig"])
def test_config_presets_equal(preset):
    a, b = getattr(tcfg, preset)(), getattr(jcfg, preset)()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert type(a).__module__ == "gem_tpu_torch.config"


def test_config_from_yaml_equal(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(_YAML)
    a, b = tcfg.config_from_yaml(str(path)), jcfg.config_from_yaml(str(path))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.map.length == 128 and a.prefilter.crop_x == (-12.0, 12.0)


def test_config_keeps_the_loader_names():
    assert tcfg.__all__ == [
        "PipelineConfig", "MapConfig", "CameraConfig", "SensorConfig",
        "BodyFilterConfig", "SubmapConfig", "benchmark_config",
        "kitti_config", "yq_config", "config_from_yaml", "validate_config"]
    for name in tcfg.__all__:
        assert hasattr(jcfg, name)


# --- msgs -----------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(tmsgs, jmsgs), (jmsgs, tmsgs)],
                         ids=["port_to_jax", "jax_to_port"])
def test_keyframes_record_crosses(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    rec = writer.KeyframesRecord(ids=np.arange(5, dtype=np.int32),
                                 poses=rng.normal(size=(5, 7))
                                 .astype(np.float32), stamp=12.5)
    path = str(tmp_path / "kf.npz")
    rec.save(path)
    got = reader.KeyframesRecord.load(path)
    np.testing.assert_array_equal(got.ids, rec.ids)
    np.testing.assert_array_equal(got.poses, rec.poses)
    assert got.stamp == rec.stamp


# --- octomap files --------------------------------------------------------


def _voxels():
    rng = np.random.default_rng(3)
    res = 0.2
    keys = np.unique(rng.integers(-60, 60, (3000, 3)), axis=0)
    xyz = (keys + 0.5) * res
    colors = rng.integers(0, 1 << 24, len(keys)).astype(np.int32)
    return xyz, colors, res


@pytest.mark.parametrize("ext", [".bt", ".ot"])
def test_octomap_files_identical(tmp_path, ext):
    xyz, colors, res = _voxels()
    out = {}
    for name, mod in (("port", toct), ("jax", joct)):
        p = str(tmp_path / f"{name}{ext}")
        if ext == ".bt":
            n = mod.write_bt(p, xyz[:, 0], xyz[:, 1], xyz[:, 2], res)
        else:
            n = mod.write_ot(p, xyz[:, 0], xyz[:, 1], xyz[:, 2], colors, res)
        out[name] = (n, _bytes(p), p)
    assert out["port"][:2] == out["jax"][:2]
    read = toct.read_bt if ext == ".bt" else toct.read_ot
    assert len(read(out["jax"][2])[1]) == len(xyz)


def test_voxelgrid_bt_identical(tmp_path):
    rng = np.random.default_rng(4)
    occ = rng.random((32, 32, 16)) < 0.05
    origin = (-3.2, -3.2, -1.0)
    for name, mod in (("port", toct), ("jax", joct)):
        mod.write_voxelgrid_bt(str(tmp_path / f"{name}.bt"), occ, origin, 0.2)
    assert _bytes(tmp_path / "port.bt") == _bytes(tmp_path / "jax.bt")


# --- pcd ------------------------------------------------------------------


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_save_pcd_identical_and_round_trips(tmp_path, binary):
    rng = np.random.default_rng(5)
    n = 500
    cols = dict(x=rng.normal(size=n).astype(np.float32),
                y=rng.normal(size=n).astype(np.float32),
                z=rng.normal(size=n).astype(np.float32),
                color_packed=rng.integers(0, 1 << 24, n).astype(np.int32),
                intensity=rng.random(n).astype(np.float32),
                variance=rng.random(n).astype(np.float32),
                traver=rng.random(n).astype(np.float32))
    valid = rng.random(n) < 0.7
    for name, mod in (("port", tpcd), ("jax", jpcd)):
        m = mod.save_pcd(str(tmp_path / f"{name}.pcd"), **cols, valid=valid,
                         binary=binary)
        assert m == int(valid.sum())
    assert _bytes(tmp_path / "port.pcd") == _bytes(tmp_path / "jax.pcd")
    back = tpcd.load_pcd(str(tmp_path / "port.pcd"))
    ref = jpcd.load_pcd(str(tmp_path / "jax.pcd"))
    assert set(back) == set(ref)
    for k in back:
        np.testing.assert_array_equal(back[k], ref[k])
    if binary:
        # ASCII prints the float-bitcast rgb with %.6f, which keeps no bits
        np.testing.assert_array_equal(back["rgb"],
                                      cols["color_packed"][valid])
    np.testing.assert_allclose(back["x"], cols["x"][valid],
                               atol=0 if binary else 1e-6)


# --- image helpers and the sensor catalog -----------------------------------


def test_image_helpers_identical(tmp_path):
    rgb = np.random.default_rng(6).integers(0, 256, (17, 23, 3), np.uint8)
    for name, mod in (("port", timage), ("jax", jimage)):
        mod.write_png(str(tmp_path / f"{name}.png"), rgb)
        mod.write_ppm(str(tmp_path / f"{name}.ppm"), rgb)
    for ext in (".png", ".ppm"):
        assert _bytes(tmp_path / f"port{ext}") == _bytes(tmp_path / f"jax{ext}")
    np.testing.assert_array_equal(timage.read_png(str(tmp_path / "jax.png")),
                                  rgb)


@pytest.mark.parametrize("name", sorted(jcat.SENSOR_PRESETS))
def test_sensor_catalog_equal(name):
    a, b = tcat.sensor_preset(name), jcat.sensor_preset(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert type(a) is tcfg.SensorConfig


def test_kitti_converter_equal(tmp_path):
    """A seeded three-scan drive (no images) through both converters, and
    a calibration file through both parsers."""
    rng = np.random.default_rng(7)
    drive = tmp_path / "drive"
    (drive / "velodyne_points" / "data").mkdir(parents=True)
    (drive / "oxts" / "data").mkdir(parents=True)
    for i in range(3):
        scan = rng.normal(size=(400, 4)).astype(np.float32) * [10, 10, 1, 0.3]
        scan.tofile(drive / "velodyne_points" / "data" / f"{i:010d}.bin")
        row = [49.01 + 1e-5 * i, 8.43 + 2e-5 * i, 112.0 + 0.1 * i,
               0.01 * i, -0.02, 1.3 + 0.05 * i] + [0.0] * 24
        (drive / "oxts" / "data" / f"{i:010d}.txt").write_text(
            " ".join(f"{v:.9f}" for v in row))
    calib = tmp_path / "calib.txt"
    calib.write_text("P_rect_02: " + " ".join(map(str, rng.normal(size=12)))
                     + "\nR_rect_00: " + " ".join(map(str, np.eye(3).ravel()))
                     + "\nTr_velo_to_cam: "
                     + " ".join(map(str, rng.normal(size=12))) + "\n")
    out = {}
    for name, mod in (("port", tkitti), ("jax", jkitti)):
        d = str(tmp_path / name)
        assert mod.convert_drive(str(drive), d) == 3
        out[name] = [dict(np.load(os.path.join(d, f)))
                     for f in sorted(os.listdir(d))]
        out[name + "_P"] = mod.projection_matrix(mod.read_calib(str(calib)))
    np.testing.assert_array_equal(out["port_P"], out["jax_P"])
    assert len(out["port"]) == len(out["jax"]) == 3
    for a, b in zip(out["port"], out["jax"]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# --- the native runtime ----------------------------------------------------


def test_both_native_libraries_built():
    assert tnative.available() and jnative.available()
    here = os.path.dirname(tnative.library_path())
    assert here.endswith(os.path.join("build", "gem_tpu_torch"))
    assert os.path.exists(tnative.library_path())


@pytest.mark.parametrize("with_intensity", [True, False])
def test_voxel_filter_equal(with_intensity):
    rng = np.random.default_rng(8)
    pts = (rng.normal(size=(20000, 3)) * [15, 15, 2]).astype(np.float32)
    pts[::97] = np.nan
    inten = rng.random(20000).astype(np.float32) if with_intensity else None
    crop = ((-20.0, 20.0), (-18.0, 18.0), (-5.0, 5.0))
    a = tnative.voxel_filter(pts, inten, leaf=0.3, crop=crop)
    b = jnative.voxel_filter(pts, inten, leaf=0.3, crop=crop)
    np.testing.assert_array_equal(a[0], b[0])
    assert len(a[0]) > 1000
    if with_intensity:
        np.testing.assert_array_equal(a[1], b[1])
    else:
        assert a[1] is None and b[1] is None


def test_dedup_cells_equal():
    rng = np.random.default_rng(9)
    n = 30000
    x = rng.uniform(-5, 5, n).astype(np.float32)
    y = rng.uniform(-5, 5, n).astype(np.float32)
    var = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.8
    a = tnative.dedup_cells(x, y, var, valid, 0.1)
    b = jnative.dedup_cells(x, y, var, valid, 0.1)
    np.testing.assert_array_equal(a, b)
    assert 1000 < len(a) < n


def test_frame_prefetcher_equal(tmp_path):
    rng = np.random.default_rng(10)
    paths = []
    for i in range(7):
        p = tmp_path / f"{i:03d}.bin"
        p.write_bytes(rng.integers(0, 256, 1000 + 337 * i, np.uint8)
                      .tobytes())
        paths.append(str(p))
    got = {}
    for name, mod in (("port", tnative), ("jax", jnative)):
        pf = mod.FramePrefetcher(paths, ring=3)
        try:
            got[name] = [pf[i] for i in range(len(pf))] + [pf[1]]
        finally:
            pf.close()
    assert got["port"] == got["jax"]
    assert got["port"][3] == _bytes(paths[3])
