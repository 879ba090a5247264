"""The port's DiSCO place recognition (gem_tpu_torch/global_map/
place_recognition.py) against gem_tpu's, jitted as multirobot/loop_detect.py
jits it, and the rotation and no-aliasing cases of
tests/test_place_recognition.py.

Signatures within 1e-4 relative (PyTorch's pocketfft and XLA's FFT differ
at the ULP level; bins are maxima, so they agree exactly unless a point
sits within an ULP of a ring or sector edge), relative yaw within 1e-3 rad.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.global_map import place_recognition as jpr
from gem_tpu.global_map import submaps as jsm

from gem_tpu_torch.global_map import place_recognition as tpr
from gem_tpu_torch.global_map import submaps as tsm

_FIELDS = ("x", "y", "z", "variance", "intensity", "traver", "color",
           "valid")


def _bufs(xy, z=None, C=512):
    n = len(xy)
    f = {"x": np.resize(xy[:, 0], C), "y": np.resize(xy[:, 1], C),
         "z": np.resize(np.zeros(n) if z is None else z, C),
         "variance": np.full(C, 0.01), "intensity": np.zeros(C),
         "traver": np.zeros(C)}
    f = {k: np.asarray(v, np.float32) for k, v in f.items()}
    f["color"] = np.zeros(C, np.int32)
    f["valid"] = np.arange(C) < n
    return (jsm.PointBuffer(**{k: jnp.asarray(f[k]) for k in _FIELDS}),
            tsm.PointBuffer(**{k: torch.from_numpy(f[k]) for k in _FIELDS}))


def _scene(rng, n=200):
    pts = [rng.normal([5, 0], 0.5, (n // 2, 2)),
           rng.normal([-3, 6], 1.0, (n // 4, 2)),
           rng.normal([0, -8], 0.8, (n // 4, 2))]
    return np.concatenate(pts).astype(np.float32)


def _rotate(xy, yaw):
    c, s = math.cos(yaw), math.sin(yaw)
    return xy @ np.asarray([[c, s], [-s, c]], np.float32)


def _terrain_submap(seed, n=400):
    """Scattered points of a submap with relief around (2, -1)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    z = 0.5 * np.sin(xy[:, 0] / 3) + 0.2 * np.cos(xy[:, 1] / 2)
    return xy, z + rng.normal(0, 0.05, n)


_jsig = jax.jit(lambda b, c: jpr.disco_signature(b, c, max_radius=25.0))
_jyaw = jax.jit(jpr.relative_yaw)


def _yaw_err(est, yaw):
    return abs((est - yaw + math.pi) % (2 * math.pi) - math.pi)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signature_matches_jax(seed):
    xy, z = _terrain_submap(seed)
    jb, tb = _bufs(xy, z)
    center = (2.0, -1.0)
    want = [np.asarray(a) for a in _jsig(jb, jnp.asarray(center))]
    got = [a.numpy() for a in tpr.disco_signature(tb, center)]
    for g, w, name in zip(got, want, ("signature", "real", "imag")):
        assert g.shape == w.shape == (32 * 64,) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    img_t = tpr.polar_bev(tb, center, 25.0).numpy()
    img_j = np.asarray(jax.jit(lambda b: jpr.polar_bev(b, center, 25.0))(jb))
    np.testing.assert_array_equal(img_t, img_j)
    assert (img_t > 0).sum() > 100


def test_match_and_yaw_match_jax():
    xy, z = _terrain_submap(3)
    yaw = 2 * math.pi * 9.4 / 64          # off the sector grid
    (ja, ta), (jb, tb) = _bufs(xy, z), _bufs(_rotate(xy, yaw), z)
    js_a, js_b = _jsig(ja, jnp.zeros(2)), _jsig(jb, jnp.zeros(2))
    ts_a = tpr.disco_signature(ta, (0.0, 0.0))
    ts_b = tpr.disco_signature(tb, (0.0, 0.0))
    sim_j = float(jpr.match_signatures(js_a[0], js_b[0]))
    sim_t = float(tpr.match_signatures(ts_a[0], ts_b[0]))
    assert abs(sim_t - sim_j) < 1e-5 and sim_t > 0.9
    est_j = float(_jyaw(js_b[1], js_b[2], js_a[1], js_a[2]))
    est_t = float(tpr.relative_yaw(ts_b[1], ts_b[2], ts_a[1], ts_a[2]))
    assert abs(est_t - est_j) < 1e-3, (est_t, est_j)
    assert _yaw_err(est_t, yaw) < 2 * math.pi / 64


def test_signature_rotation_invariant_and_discriminative():
    rng = np.random.default_rng(0)
    scene = _scene(rng)
    yaw = 2 * math.pi * 37 / 64          # exact sector multiple
    sig_a = tpr.disco_signature(_bufs(scene, C=256)[1], (0.0, 0.0))[0]
    sig_b = tpr.disco_signature(_bufs(_rotate(scene, yaw), C=256)[1],
                                (0.0, 0.0))[0]
    sig_c = tpr.disco_signature(
        _bufs(_scene(np.random.default_rng(99)), C=256)[1], (0.0, 0.0))[0]
    sim_same = float(tpr.match_signatures(sig_a, sig_b))
    sim_diff = float(tpr.match_signatures(sig_a, sig_c))
    assert sim_same > 0.98
    assert sim_diff < sim_same - 0.05


@pytest.mark.parametrize("sectors", [11, 21])
def test_relative_yaw_recovered(sectors):
    scene = _scene(np.random.default_rng(1))
    yaw = 2 * math.pi * sectors / 64
    _, ar, ai = tpr.disco_signature(_bufs(scene, C=256)[1], (0.0, 0.0))
    _, br, bi = tpr.disco_signature(_bufs(_rotate(scene, yaw), C=256)[1],
                                    (0.0, 0.0))
    est = float(tpr.relative_yaw(br, bi, ar, ai))
    assert _yaw_err(est, yaw) < 2 * math.pi / 64 * 1.5, (est, yaw)


def test_relative_yaw_no_aliasing_on_self_similar_scene():
    """Equal blobs at theta=0 (r=5) and theta=pi (r=10): the ring-summed
    profile aliases under a pi rotation, the per-ring spectra do not."""
    rng = np.random.default_rng(7)
    n = 128
    scene = np.concatenate([
        np.stack([rng.normal(5.0, 0.2, n), rng.normal(0.0, 0.2, n)], -1),
        np.stack([rng.normal(-10.0, 0.2, n), rng.normal(0.0, 0.2, n)], -1)
    ]).astype(np.float32)
    _, ar, ai = tpr.disco_signature(_bufs(scene)[1], (0.0, 0.0))
    for yaw in (math.pi, 2 * math.pi * 21 / 64):
        _, br, bi = tpr.disco_signature(_bufs(_rotate(scene, yaw))[1],
                                        (0.0, 0.0))
        est = float(tpr.relative_yaw(br, bi, ar, ai))
        assert _yaw_err(est, yaw) < 2 * math.pi / 64 * 1.5, (est, yaw)


def test_empty_submap_has_a_zero_signature():
    jb, tb = _bufs(np.zeros((0, 2), np.float32), C=64)
    got = tpr.disco_signature(tb, (0.0, 0.0))[0].numpy()
    want = np.asarray(_jsig(jb, jnp.zeros(2))[0])
    np.testing.assert_array_equal(got, want)
    assert not got.any()
