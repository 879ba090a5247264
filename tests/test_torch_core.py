"""The PyTorch port's core, sensor, motion, point-processing and replay
modules against the JAX package on the CPU.

Inputs are made with NumPy from a seed and fed to both packages.  Where the
port's arithmetic is the reference's op for op, results are compared
bitwise; tolerances, where stated, cover only summation order.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.config import (BodyFilterConfig, CameraConfig, PipelineConfig,
                            SensorConfig, benchmark_config)
from gem_tpu.core import index_math as jim
from gem_tpu.core import move as jmove
from gem_tpu.core.state import init_map_state as jinit_map
from gem_tpu.io import replay as jreplay
from gem_tpu.kernels import pointproc as jpp
from gem_tpu.motion import updater as jmot
from gem_tpu.sensors import models as jsens

import reference_semantics as ref
from gem_tpu_torch.core import index_math as tim
from gem_tpu_torch.core import move as tmove
from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.io import replay as treplay
from gem_tpu_torch.kernels import pointproc as tpp
from gem_tpu_torch.kernels.fuse import FUSE_BACKENDS, fuse as tfuse
from gem_tpu_torch.motion import updater as tmot
from gem_tpu_torch.sensors import models as tsens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _maps(mcfg, seed, occupancy=0.6, start=(5, 11), center=(0.3, -0.45)):
    """The same random map as a JAX MapState and a port MapState."""
    rng = np.random.default_rng(seed)
    L = mcfg.length
    occ = rng.random((L, L)) < occupancy
    elev = np.where(occ, rng.normal(size=(L, L)),
                    mcfg.invalid_elevation).astype(np.float32)
    var = np.where(occ, rng.uniform(1e-4, 0.1, (L, L)),
                   mcfg.invalid_variance).astype(np.float32)
    trav = np.where(occ & (rng.random((L, L)) < 0.8), rng.random((L, L)),
                    mcfg.invalid_traversability).astype(np.float32)
    color = np.where(occ, rng.integers(0, 1 << 24, (L, L)), 0).astype(
        np.int32)
    js = jinit_map(mcfg).replace(
        elevation=jnp.asarray(elev), variance=jnp.asarray(var),
        traver=jnp.asarray(trav), color=jnp.asarray(color),
        intensity=jnp.asarray(rng.random((L, L)).astype(np.float32)),
        lowest=jnp.asarray(rng.normal(size=(L, L)).astype(np.float32)),
        start=jnp.asarray(start, jnp.int32),
        center=jnp.asarray(center, jnp.float32),
        sensor_z=jnp.float32(1.25))
    ts = MapState(**{f.name: T(getattr(js, f.name))
                     for f in dataclasses.fields(MapState)})
    return js, ts


def _assert_tree_equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(N(getattr(a, f)), N(getattr(b, f)),
                                      err_msg=f)


# --- package ------------------------------------------------------------


def test_import_leaves_jax_out_and_tf32_off():
    code = ("import sys, torch, gem_tpu_torch, gem_tpu_torch.mapping.pipeline,"
            " gem_tpu_torch.io.replay, gem_tpu_torch.config;"
            " assert 'jax' not in sys.modules, 'jax imported';"
            " assert 'gem_tpu' not in sys.modules, 'gem_tpu imported';"
            " assert not torch.backends.cuda.matmul.allow_tf32;"
            " assert not torch.backends.cudnn.allow_tf32; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_exports_the_names_gem_tpu_exports():
    """Every name `import gem_tpu` exports (its config classes and presets,
    MapState, init_map_state, and lazily ElevationPipeline, Frame,
    PipelineState and step) resolves in the port to the port's own
    object of that name; `import gem_tpu_torch` stays light."""
    import inspect

    import gem_tpu
    import gem_tpu_torch

    names = [n for n, v in vars(gem_tpu).items()
             if not n.startswith("_") and not inspect.ismodule(v)]
    names += ["ElevationPipeline", "Frame", "PipelineState", "step"]
    assert {"MapConfig", "benchmark_config", "init_map_state"} <= set(names)
    for name in names:
        want, got = getattr(gem_tpu, name), getattr(gem_tpu_torch, name)
        assert got.__name__ == want.__name__, name
        assert got.__module__.replace("gem_tpu_torch", "gem_tpu") \
            == want.__module__, name
    from gem_tpu_torch import (ElevationPipeline, MapConfig,  # noqa: F401
                               benchmark_config, step)
    with pytest.raises(AttributeError):
        gem_tpu_torch.not_a_name
    code = ("import sys, gem_tpu_torch;"
            " assert 'gem_tpu_torch.mapping.pipeline' not in sys.modules;"
            " assert gem_tpu_torch.step.__module__"
            " == 'gem_tpu_torch.mapping.pipeline'; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_config_is_the_shared_source():
    """The port's own copy of the config module (it reads nothing under
    gem_tpu/) holds the JAX package's configuration tree."""
    from gem_tpu_torch import config as tcfg

    a, b = tcfg.benchmark_config(), benchmark_config()
    assert type(a).__module__ == "gem_tpu_torch.config"
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(a)] \
        == [f.name for f in dataclasses.fields(b)]
    assert tcfg.kitti_config().map.length == 75
    stereo = tcfg.PipelineConfig().sensor.__class__(model="stereo")
    with pytest.raises(ValueError):
        tcfg.validate_config(tcfg.PipelineConfig(sensor=stereo))


# --- index math -----------------------------------------------------------


def test_round_half_away_is_c_round():
    x = np.array([-3.5, -2.5, -1.5, -0.5, -0.49, 0.0, 0.49, 0.5, 1.5, 2.5,
                  3.5, 1e6 + 0.5, -7.25], np.float32)
    got = N(tim.round_half_away(T(x)))
    np.testing.assert_array_equal(got, [ref.c_round(float(v)) for v in x])
    np.testing.assert_array_equal(got, N(jim.round_half_away(jnp.asarray(x))))
    # torch.round would round half to even
    assert N(torch.round(T(x)))[1] == -2.0 and got[1] == -3.0


@pytest.mark.parametrize("resolution", [0.1, 0.2, 0.25])
def test_index_shift_and_align(resolution):
    rng = np.random.default_rng(1)
    shifts = np.concatenate([np.linspace(-3.7, 3.7, 113),
                             rng.normal(0, 20, 400)]).astype(np.float32)
    got = N(tim.index_shift_from_position_shift(T(shifts), resolution))
    np.testing.assert_array_equal(
        got, ref.index_shift_from_position_shift(shifts, resolution))
    np.testing.assert_array_equal(got, N(jim.index_shift_from_position_shift(
        jnp.asarray(shifts), resolution)))
    c = rng.normal(0, 30, (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        N(tim.align_position(T(c), T(shifts[:128].reshape(64, 2)),
                             resolution)),
        N(jim.align_position(jnp.asarray(c),
                             jnp.asarray(shifts[:128].reshape(64, 2)),
                             resolution)))


@pytest.mark.parametrize("length", [74, 75])
@pytest.mark.parametrize("resolution", [0.1, 0.2])
def test_position_to_geo_index(length, resolution):
    rng = np.random.default_rng(length)
    center = np.array([1.3, -2.7], np.float32)
    span = length * resolution
    pts = (rng.uniform(-0.7 * span, 0.7 * span, (4096, 2)) + center).astype(
        np.float32)
    got = tim.position_to_geo_index(T(pts[:, 0]), T(pts[:, 1]), T(center),
                                    length, resolution)
    want = jim.position_to_geo_index(jnp.asarray(pts[:, 0]),
                                     jnp.asarray(pts[:, 1]),
                                     jnp.asarray(center), length, resolution)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), N(w))
    for i in range(0, 4096, 97):
        c = ref.points_to_index(float(pts[i, 0]), float(pts[i, 1]), center,
                                length, resolution)
        assert bool(got[2][i]) == (c is not None)
        if c is not None:
            assert (int(got[0][i]), int(got[1][i])) == c


def test_storage_maps_and_rolls():
    L = 37
    start = np.array([13, 30], np.int32)
    g = np.arange(L, dtype=np.int32)
    sx, sy = tim.geo_to_storage(T(g), T(g[::-1].copy()), T(start), L)
    np.testing.assert_array_equal(N(sx), (g + start[0]) % L)
    gx, gy = tim.storage_to_geo(sx, sy, T(start), L)
    np.testing.assert_array_equal(N(gx), g)
    np.testing.assert_array_equal(N(gy), g[::-1])
    plane = np.random.default_rng(0).normal(size=(L, L)).astype(np.float32)
    geo = N(tim.roll_to_geo(T(plane), T(start)))
    np.testing.assert_array_equal(geo, np.roll(plane, (-13, -30), (0, 1)))
    np.testing.assert_array_equal(
        N(tim.roll_to_storage(T(geo), T(start))), plane)


@pytest.mark.parametrize("start,shift", [(0, 3), (5, -4), (36, 40),
                                         (2, -37), (10, 0)])
def test_shift_clear_band_and_mask(start, shift):
    L = 37
    got = tim.shift_clear_band(torch.tensor(start, dtype=torch.int32),
                               torch.tensor(shift, dtype=torch.int32), L)
    want = jim.shift_clear_band(jnp.int32(start), jnp.int32(shift), L)
    assert [int(x) for x in got] == [int(x) for x in want]
    idx = np.arange(L, dtype=np.int32)
    np.testing.assert_array_equal(
        N(tim.band_mask(T(idx), got[0], got[1], L)),
        N(jim.band_mask(jnp.asarray(idx), want[0], want[1], L)))


# --- move / re_anchor -------------------------------------------------------


_SHED_FIELDS = ("x", "y", "z", "variance", "color", "intensity", "traver",
                "valid", "dropped")
_MAP_FIELDS = ("elevation", "variance", "intensity", "lowest", "traver",
               "color", "start", "center", "sensor_z")


@pytest.mark.parametrize("length,position", [
    (32, (0.75, -0.55, 0.4)),     # small shift, both axes
    (32, (-1.9, 0.05, 0.0)),      # rows only, negative
    (33, (2.6, 3.3, -1.0)),       # odd length, beyond max_shift_cells
    (32, (40.0, 0.0, 0.0)),       # full clear
])
def test_move_matches_jax(length, position):
    cfg = benchmark_config(length=length).map
    cfg = dataclasses.replace(cfg, resolution=0.2, max_shift_cells=6)
    js, ts = _maps(cfg, seed=length)
    jm, jinfo = jmove.move(js, cfg, jnp.asarray(position, jnp.float32))
    tm, tinfo = tmove.move(ts, cfg, T(np.asarray(position, np.float32)))
    _assert_tree_equal(jm, tm, _MAP_FIELDS)
    _assert_tree_equal(jinfo.shed, tinfo.shed, _SHED_FIELDS)
    np.testing.assert_array_equal(N(jinfo.index_shift), N(tinfo.index_shift))
    # G_Clear_map: band clears leave lowest untouched
    np.testing.assert_array_equal(N(tm.lowest), N(ts.lowest))


def test_re_anchor_matches_jax():
    cfg = dataclasses.replace(benchmark_config(length=24).map,
                              resolution=0.25)
    js, ts = _maps(cfg, seed=3)
    pos = np.array([3.1, -2.2, 0.3], np.float32)
    a = jmove.re_anchor(js, cfg, jnp.asarray(pos), jnp.float32(0.17))
    b = tmove.re_anchor(ts, cfg, T(pos), torch.tensor(0.17))
    _assert_tree_equal(a, b, _MAP_FIELDS)


# --- sensors / motion ---------------------------------------------------------


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


@pytest.mark.parametrize("model", ["laser", "structured_light", "stereo",
                                   "perfect"])
def test_height_variance_matches_jax(model):
    rng = np.random.default_rng(7)
    scfg = SensorConfig(model=model, p_1=0.01, p_2=0.002, p_3=0.4, p_4=2.0,
                        p_5=0.001, depth_to_disparity_factor=40.0)
    pts = rng.uniform(-8, 8, (2048, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.4
    uv = rng.uniform(0, 600, (2048, 2)).astype(np.float32)
    R_mb, R_bs = _rot(rng), _rot(rng)
    t_bs = rng.normal(size=3).astype(np.float32)
    cov = rng.normal(size=(3, 3)).astype(np.float32) * 0.01
    cov = (cov @ cov.T).astype(np.float32)
    ji = jsens.jacobian_ingredients(R_mb, R_bs, t_bs)
    ti = tsens.jacobian_ingredients(T(R_mb), T(R_bs), T(t_bs))
    for a, b in zip(ji, ti):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-6, atol=1e-7)
    want = N(jsens.height_variance(scfg, pts, ji[0], cov, *ji[1:],
                                   pixel_uv=jnp.asarray(uv)))
    got = N(tsens.height_variance(scfg, T(pts), ti[0], T(cov), *ti[1:],
                                  pixel_uv=T(uv)))
    # einsum vs written-out 3-term contractions: reassociation only
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-9)


def test_motion_process_noise_matches_jax():
    rng = np.random.default_rng(9)
    jm, tm = jmot.init_motion_state(), tmot.init_motion_state("cpu")
    for _ in range(4):
        pos = rng.normal(size=3).astype(np.float32)
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        a = rng.normal(size=(6, 6)).astype(np.float32) * 0.05
        cov = (a @ a.T).astype(np.float32)
        ju, jm = jmot.process_noise(pos, q, cov, jm, 1.5)
        tu, tm = tmot.process_noise(T(pos), T(q), T(cov), tm, 1.5)
        # 4x4 matmul chains in another summation order
        np.testing.assert_allclose(float(tu), float(ju), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(N(tm.prev_reduced_cov),
                                   N(jm.prev_reduced_cov), rtol=1e-5,
                                   atol=1e-7)
    var = np.array([-10.0, 0.5, 1e-4], np.float32)
    np.testing.assert_array_equal(
        N(tmot.apply_process_noise(T(var), torch.tensor(0.25))),
        N(jmot.apply_process_noise(jnp.asarray(var), 0.25)))


# --- point processing ---------------------------------------------------------


@pytest.mark.parametrize("case", ["identity", "rotated", "box_filter",
                                  "camera", "no_filter"])
def test_process_points_matches_jax(case):
    rng = np.random.default_rng(11)
    P = 2048
    kw = dict(map=dataclasses.replace(benchmark_config(length=40).map,
                                      resolution=0.2), max_points=P)
    if case == "box_filter":
        kw["body_filter"] = BodyFilterConfig(mode="box")
    if case in ("no_filter", "camera"):
        kw["body_filter"] = BodyFilterConfig(mode="none")
    kw["sensor"] = SensorConfig(ignore_points_above=1.5,
                                ignore_points_below=-3.0)
    image = None
    if case == "camera":
        proj = np.array([[300, 0, 160, 0.1], [0, 300, 120, -0.2],
                         [0, 0, 1, 0.05]], np.float32)
        kw["camera"] = CameraConfig(image_height=240, image_width=320,
                                    projection=tuple(proj.ravel().tolist()))
        image = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
        kw["sensor"] = SensorConfig()          # points ahead, no band cut
    cfg = PipelineConfig(**kw)
    js, ts = _maps(cfg.map, seed=2)
    pts = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    if case == "camera":
        pts[:, 2] = rng.uniform(0.5, 6.0, P)
    pts[5] = np.nan
    inten = rng.uniform(0, 50, P).astype(np.float32)
    valid = rng.random(P) < 0.9
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 3] = [0.4, -0.3, 1.1]
    if case == "rotated":
        tf[:3, :3] = _rot(rng)
    colors = rng.integers(0, 1 << 24, P).astype(np.int32)
    R = np.eye(3, dtype=np.float32)
    zero3 = np.zeros(3, np.float32)
    cov = np.eye(3, dtype=np.float32) * 1e-4
    ji = jsens.jacobian_ingredients(R, R, zero3)
    ti = tsens.jacobian_ingredients(T(R), T(R), T(zero3))
    jb, _ = jpp.process_points(
        js, cfg, pts, inten, valid, tf, jnp.float32(0.2), ji[0], cov,
        *ji[1:], image=None if image is None else jnp.asarray(image),
        colors=jnp.asarray(colors), compute_lowest=False)
    tb = tpp.process_points(
        ts, cfg, T(pts), T(inten), T(valid), T(tf), torch.tensor(0.2),
        ti[0], T(cov), *ti[1:], image=None if image is None else T(image),
        colors=T(colors))
    np.testing.assert_array_equal(N(tb.valid), N(jb.valid))
    np.testing.assert_array_equal(N(tb.color), N(jb.color))
    v = N(tb.valid)
    if case == "rotated":
        # 3-term products summed in another order: a 1-ULP coordinate may
        # bin across a cell edge, so cells agree on nearly all points
        assert (N(tb.cell) == N(jb.cell)).mean() > 0.995
        np.testing.assert_allclose(N(tb.height)[v], N(jb.height)[v],
                                   atol=2e-6)
    else:
        np.testing.assert_array_equal(N(tb.cell), N(jb.cell))
        np.testing.assert_array_equal(N(tb.height)[v], N(jb.height)[v])
    np.testing.assert_allclose(N(tb.variance)[v], N(jb.variance)[v],
                               rtol=2e-6)
    assert v.sum() > 100


def test_colorize_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (1024, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.5, 6.0, 1024)
    proj = np.array([[200, 0, 64, 0], [0, 200, 48, 0], [0, 0, 1, 0]],
                    np.float32).ravel()
    img = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    jc, jok = jpp.colorize(jnp.asarray(pts), jnp.asarray(img), proj)
    tc, tok = tpp.colorize(T(pts), T(img), proj)
    np.testing.assert_array_equal(N(tc), N(jc))
    np.testing.assert_array_equal(N(tok), N(jok))
    assert N(tok).sum() > 50


def test_lowest_reduction_single_cell():
    """The `lowest` bound that every fuse backend applies (its parity with
    gem_tpu is tests/test_torch_fuse.py): eight points in one cell at 0.5
    m give that geographic cell h + 3v of the lowest, max-v winner."""
    cfg = benchmark_config(length=16, max_points=8).replace(
        body_filter=BodyFilterConfig(mode="none"))
    _, ts = _maps(cfg.map, seed=0)
    ts = ts.replace(lowest=torch.full((16, 16), 100.0))
    z = torch.zeros(3)
    pts = torch.zeros(8, 3)
    pts[:, 2] = torch.tensor([0.5, 0.7, 0.5, 0.9, 1.0, 0.6, 0.8, 0.5])
    batch = tpp.process_points(
        ts, cfg, pts, torch.zeros(8), torch.ones(8, dtype=torch.bool),
        torch.eye(4), torch.tensor(0.0), z, torch.eye(3), torch.eye(3), z,
        torch.zeros(3, 3))
    want = np.float32(0.5) + np.float32(3.0) * N(batch.variance)[0]
    for backend in FUSE_BACKENDS:
        low = tfuse(ts, cfg, batch, backend=backend).lowest
        changed = torch.nonzero(low != 100.0)
        assert changed.shape[0] == 1, backend
        assert N(low)[tuple(changed[0].tolist())] == want, backend


# --- replay -------------------------------------------------------------------


def test_synthetic_frames_identical_to_jax_package():
    cfg = benchmark_config(length=40, max_points=1024)
    ja = list(jreplay.synthetic_frames(cfg, 3, n_points=900, speed=0.7,
                                       seed=5))
    tb = list(treplay.synthetic_frames(cfg, 3, n_points=900, speed=0.7,
                                       seed=5, device="cpu"))
    for (jf, jxy, jw), (tf, txy, tw) in zip(ja, tb):
        assert jxy == txy
        for f in dataclasses.fields(tf):
            a, b = getattr(jf, f.name), getattr(tf, f.name)
            if a is None:
                assert b is None
                continue
            assert N(b).dtype == np.asarray(a).dtype, f.name
            np.testing.assert_array_equal(N(b), np.asarray(a),
                                          err_msg=f.name)
        x = np.linspace(-20, 20, 50)
        np.testing.assert_array_equal(tw.height(x, -x), jw.height(x, -x))

