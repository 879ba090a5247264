"""The port's voxel pyramid (gem_tpu_torch/global_map/pyramid.py) and octomap
export against gem_tpu's, called as the `run` CLIs call them (eagerly, so
`/ resolution` is a true division in both).

Occupancy is a scatter-set and color a scatter-max, both order-free, and the
outlier mask compares integer densities with a threshold: every grid is
compared bitwise, and the `.bt` / `.ot` files byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.global_map import pyramid as jpy
from gem_tpu.global_map.octomap_io import (read_bt, read_ot, write_ot,
                                           write_voxelgrid_bt)

from gem_tpu_torch.global_map import pyramid as tpy
from gem_tpu_torch.io import cli as tcli

ORIGIN, RES, SHAPE = (-6.0, -6.0, -2.0), 0.1, (120, 120, 40)


def _cloud(seed, n=6000):
    """Dense terrain patches, isolated fliers (the outlier filter's prey),
    points exactly on voxel faces, invalid rows and traversability on both
    sides of the threshold."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(1.0, 1.5, n), rng.uniform(-6, 6, 40),
                        ORIGIN[0] + RES * rng.integers(0, 120, 200)])
    y = np.concatenate([rng.normal(-0.5, 1.5, n), rng.uniform(-6, 6, 40),
                        ORIGIN[1] + RES * rng.integers(0, 120, 200)])
    m = x.shape[0]
    z = 0.2 * np.sin(x) + rng.normal(0, 0.05, m)
    c = {"x": x.astype(np.float32), "y": y.astype(np.float32),
         "z": z.astype(np.float32),
         "color": rng.integers(0, 1 << 24, m).astype(np.int32),
         "traver": rng.random(m).astype(np.float32),
         "valid": rng.random(m) < 0.95}
    return c


def _pair(c):
    j = {k: jnp.asarray(v) for k, v in c.items()}
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    return j, t


def _pyramids(c, **kw):
    j, t = _pair(c)
    args = ("x", "y", "z", "color", "traver", "valid")
    kw = dict(origin=ORIGIN, base_resolution=RES, shape=SHAPE,
              travers_threshold=0.6, **kw)
    return (jpy.build_pyramid(*(j[a] for a in args), **kw),
            tpy.build_pyramid(*(t[a] for a in args), **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_outlier_mask_bitwise(seed):
    c = _cloud(seed)
    j, t = _pair(c)
    want = np.asarray(jpy.statistical_outlier_mask(j["x"], j["y"], j["z"],
                                                   j["valid"]))
    got = tpy.statistical_outlier_mask(t["x"], t["y"], t["z"], t["valid"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((c["valid"] & ~want).sum()) < 0.5 * c["valid"].sum()


def test_outlier_mask_key_wraps_like_int32():
    """Coarse cells 65536 apart share a key in the reference (16-bit fields
    of an int32); far points therefore count as one cell in both."""
    x = np.asarray([0.5, 65536.5, 65536.5, 3.5], np.float32)
    y = np.asarray([0.5, 0.5, 0.5, 3.5], np.float32)
    v = np.ones(4, bool)
    want = np.asarray(jpy.statistical_outlier_mask(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(y), jnp.asarray(v)))
    got = tpy.statistical_outlier_mask(torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       torch.from_numpy(y),
                                       torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [True, True, True, False]


@pytest.mark.parametrize("seed,outlier_filter", [(0, True), (1, False)])
def test_pyramid_levels_bitwise(seed, outlier_filter):
    (jroad, jobs), (troad, tobs) = _pyramids(_cloud(seed), levels=3,
                                             outlier_filter=outlier_filter)
    for jl, tl in ((jroad, troad), (jobs, tobs)):
        assert len(tl) == len(jl) == 3
        for jg, tg in zip(jl, tl):
            np.testing.assert_array_equal(tg.occupancy.numpy(),
                                          np.asarray(jg.occupancy))
            np.testing.assert_array_equal(tg.color.numpy(),
                                          np.asarray(jg.color))
            assert tg.origin == jg.origin
            assert tg.resolution == jg.resolution
    assert int(troad[0].occupancy.sum()) > 1000
    assert int(tobs[0].occupancy.sum()) > 500
    assert tuple(troad[2].occupancy.shape) == (30, 30, 10)


def test_pyramid_occupancy_and_pooling():
    """The JAX suite's hand example."""
    xs = torch.tensor([0.1, 0.9, 3.5])
    ys = torch.tensor([0.1, 0.1, 3.5])
    zs = torch.tensor([0.1, 0.1, 1.5])
    trav = torch.tensor([0.9, 0.9, 0.1])
    colors = torch.tensor([0xFF0000, 0x00FF00, 0x0000FF], dtype=torch.int32)
    road, obs = tpy.build_pyramid(xs, ys, zs, colors, trav,
                                  torch.ones(3, dtype=torch.bool),
                                  origin=(0, 0, 0), base_resolution=0.5,
                                  shape=(8, 8, 4), travers_threshold=0.5,
                                  levels=2, outlier_filter=False)
    r0 = road[0].occupancy
    assert r0[0, 0, 0] and r0[1, 0, 0] and not r0[7, 7, 3]
    assert obs[0].occupancy[7, 7, 3]
    assert int(obs[0].color[7, 7, 3]) == 0x0000FF
    assert road[1].occupancy[0, 0, 0] and road[1].resolution == 1.0
    assert int(road[1].color[0, 0, 0]) == 0xFF0000


def _jax_cli_write(path, road, obs):
    """gem_tpu/io/cli.py's .bt / .ot writer on the reference's grids."""
    ext, stem = path[-3:], path[:-3]
    for name, g in (("road", road[0]), ("obstacle", obs[0])):
        p = f"{stem}_{name}{ext}"
        occ = np.asarray(g.occupancy)
        if ext == ".bt":
            write_voxelgrid_bt(p, occ, g.origin, g.resolution)
        else:
            idx = np.argwhere(occ)
            col = np.asarray(g.color)[idx[:, 0], idx[:, 1], idx[:, 2]]
            write_ot(p, g.origin[0] + (idx[:, 0] + 0.5) * g.resolution,
                     g.origin[1] + (idx[:, 1] + 0.5) * g.resolution,
                     g.origin[2] + (idx[:, 2] + 0.5) * g.resolution,
                     col, g.resolution)


@pytest.mark.parametrize("ext", [".bt", ".ot"])
def test_octomap_files_byte_identical(tmp_path, ext):
    (jroad, jobs), (troad, tobs) = _pyramids(_cloud(2))
    _jax_cli_write(str(tmp_path / f"j{ext}"), jroad, jobs)
    written = tcli.save_octomap(str(tmp_path / f"t{ext}"), troad, tobs)
    assert [w[0] for w in written] == ["road", "obstacle"]
    for name, path, nodes in written:
        got = open(path, "rb").read()
        assert got == open(tmp_path / f"j_{name}{ext}", "rb").read(), name
        assert nodes > 0
    occ = troad[0].occupancy.numpy()
    if ext == ".bt":
        tree = read_bt(str(tmp_path / f"t_road{ext}"))
    else:
        tree = read_ot(str(tmp_path / f"t_road{ext}"))
    assert len(tree[1]) == int(occ.sum())


def test_octomap_npz_holds_every_level(tmp_path):
    _, (road, obs) = _pyramids(_cloud(3))
    path = str(tmp_path / "p.npz")
    assert tcli.save_octomap(path, road, obs) == [("levels", path, None)]
    d = np.load(path)
    for name, levels in (("road", road), ("obstacle", obs)):
        for i, g in enumerate(levels):
            np.testing.assert_array_equal(d[f"{name}_l{i}_occ"],
                                          g.occupancy.numpy())
            assert float(d[f"{name}_l{i}_res"]) == np.float32(g.resolution)
    np.testing.assert_array_equal(d["origin"], np.float32(ORIGIN))
