"""The port's fleet (gem_tpu_torch/multirobot/fleet.py) against gem_tpu's
vmapped `fleet_step`, and against the port's own single-robot `step`.

JAX side: `fleet_step` (segment fuse + XLA features, jitted, on the CPU).
Port side: `fleet_step(fuse_backend="segment")` on the CPU.  Per robot,
after every frame: elevation and variance within rtol 1e-6 (the JAX suite's
own bound for its fleet tests) and atol 1e-6 (a height near 0 m keeps the
rounding of the metre-scale terms it was summed from), the submap
bookkeeping (`counts`, `accum_count`, `dropped`, `num_submaps`,
`kf_counts`) equal, and
traversability within the eigen-gap-scaled bound of
tests/test_torch_features.py (raytrace off, so the final elevation is the
one the features saw).  Against the port's `step`, robot by robot: every
leaf bitwise.  Also the device default: the entry points run on the card
unless asked for the CPU, and raise without one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gem_tpu.config as jconfig
from gem_tpu.io.replay import synthetic_frames as jframes
from gem_tpu.multirobot import fleet as jfleet

from gem_tpu_torch import config as tconfig
from gem_tpu_torch.io import checkpoint as tck
from gem_tpu_torch.io import replay as treplay
from gem_tpu_torch.mapping import pipeline as tp
from gem_tpu_torch.multirobot import fleet as tfleet
from gem_tpu_torch.utils.tree import tree_leaves, tree_map

from test_torch_features import _relative_gap

_BOOK = ("counts", "accum_count", "dropped", "num_submaps", "kf_counts")


def _cfg(pkg_config, raytrace=True):
    """tests/test_multirobot.py's realistic-shapes fleet configuration."""
    C = pkg_config
    return C.PipelineConfig(
        map=C.MapConfig(length=48, resolution=0.25, max_shift_cells=8),
        sensor=C.SensorConfig(model="laser"),
        body_filter=C.BodyFilterConfig(mode="none"),
        submap=C.SubmapConfig(max_submaps=3, capacity=128,
                              keyframe_distance=1.0),
        max_points=512, enable_raytrace=raytrace)


def _streams(cfg, n, T):
    """Uneven streams: robot r sees 64 + 56 r points at 0.35 + 0.1 r m per
    frame (tests/test_multirobot.py)."""
    return [[f for f, _, _ in jframes(cfg, T, n_points=64 + 56 * r,
                                      speed=0.35 + 0.1 * r, seed=100 + r)]
            for r in range(n)]


def _port_frames(frames):
    return tfleet.stack_frames([tp.frame_from_numpy(f, "cpu")
                                for f in frames])


def _jax_frames(frames):
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                        *frames)


def _check_robot(t, j, to, jo, cfg, r, what):
    """Port fleet state `t` vs JAX fleet state `j` (NumPy trees) and their
    step outputs, robot r."""
    tm, jm = t.map, j.map
    for k in ("elevation", "variance"):
        np.testing.assert_allclose(getattr(tm, k)[r], getattr(jm, k)[r],
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what} r{r} {k}")
    for k in _BOOK:
        np.testing.assert_array_equal(getattr(t.submaps, k)[r],
                                      getattr(j.submaps, k)[r],
                                      err_msg=f"{what} r{r} {k}")
    # tests/test_torch_features.py's bound, per cell
    nz = np.asarray(jo.features.normal_z[r]).astype(np.float64)
    tol = np.maximum(1e-5, 8e-6 / np.maximum(
        _relative_gap(jm.elevation[r], jm.start[r], cfg.map), 1e-30))
    tol = tol / np.sqrt(np.maximum(1.0 - nz * nz, 1e-12))
    tol = np.where(nz > 1.0 - 1e-6, np.maximum(tol, 1e-3), tol)
    for got, want in ((tm.traver[r], jm.traver[r]),
                      (to.features.traver[r].numpy(),
                       np.asarray(jo.features.traver[r]))):
        d = np.abs(got - want)
        assert (d <= tol).all(), (what, r, float(d.max()))


def test_fleet_matches_jax_per_robot_uneven_overflow():
    """8 robots, 6 frames, uneven streams and speeds, a 128-point submap
    capacity that overflows unevenly, keyframes and a wrapped ring; then
    the JAX fleet state after 6 frames is handed to the port, and both step
    on for 2 more frames."""
    cfg_j = _cfg(jconfig, raytrace=False)
    cfg_t = _cfg(tconfig, raytrace=False)
    n, T = 8, 8
    streams = _streams(cfg_j, n, T)
    jf = jax.jit(functools.partial(jfleet.fleet_step, cfg=cfg_j))
    js = jfleet.make_fleet_state(cfg_j, n)
    ts = tfleet.make_fleet_state(cfg_t, n, device="cpu")
    for t in range(6):
        frames = [streams[r][t] for r in range(n)]
        js, jo = jf(js, _jax_frames(frames))
        ts, to = tfleet.fleet_step(ts, _port_frames(frames), cfg_t,
                                   fuse_backend="segment")
        a, b = tp.state_to_numpy(ts), jax.tree.map(np.asarray, js)
        for r in range(n):
            _check_robot(a, b, to, jo, cfg_j, r, f"frame {t}")
        np.testing.assert_array_equal(to.metrics["points_valid"].numpy(),
                                      np.asarray(jo.metrics["points_valid"]))
    pv = to.metrics["points_valid"].numpy()
    dropped = ts.submaps.dropped.numpy()
    assert len(set(pv.tolist())) > 4, pv
    assert dropped.max() > 0 and len(set(dropped.tolist())) > 1, dropped
    assert int(ts.submaps.num_submaps.max()) > 3       # a ring wrapped

    # the JAX fleet state converts unchanged and steps on
    hs = tp.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for t in range(6, T):
        frames = [streams[r][t] for r in range(n)]
        js, jo = jf(js, _jax_frames(frames))
        hs, ho = tfleet.fleet_step(hs, _port_frames(frames), cfg_t,
                                   fuse_backend="segment")
        a, b = tp.state_to_numpy(hs), jax.tree.map(np.asarray, js)
        for r in range(n):
            _check_robot(a, b, ho, jo, cfg_j, r, f"handed over, frame {t}")


def _jump_streams(cfg, n, T):
    """Port frames for n robots: uneven streams as above, and robot 1 alone
    closes a loop at frame 3 (pose +0.5 m, z +0.3 m, held, then released
    at frame 7, so its jump settles and finishes)."""
    streams = []
    for r in range(n):
        fr = [f for f, _, _ in treplay.synthetic_frames(
            cfg, T, n_points=64 + 56 * r, speed=0.35 + 0.1 * r, seed=100 + r,
            device="cpu")]
        if r == 1:
            jz = None
            for i in range(3, T):
                tr = fr[i].track_position.clone()
                tr[0] += 0.5
                if i == 3:
                    tr[2] += 0.3
                    jz = tr[2].clone()
                    fr[i] = dataclasses.replace(
                        fr[i], track_position=tr,
                        loop_closure=torch.ones((), dtype=torch.bool))
                    continue
                tr[2] = jz if i < 7 else jz + 0.05
                fr[i] = dataclasses.replace(fr[i], track_position=tr)
        streams.append(fr)
    return streams


@pytest.mark.parametrize("backend", ["stream", "segment", "pallas"])
def test_fleet_equals_single_robot_step_bitwise(backend):
    """Robot by robot, after every frame, every leaf of the fleet state
    equals the port's own `step` run on that robot alone, over 10 frames
    with keyframes, a wrapped ring, an uneven capacity overflow and a
    loop-closure jump on robot 1 only (the leaves `step` replaces must be
    copied back into the stack, the rings it updates in place not)."""
    cfg = _cfg(tconfig)
    ecfg = tfleet.fleet_effective_config(cfg)
    n, T = 4, 10
    streams = _jump_streams(cfg, n, T)
    fleet = tfleet.make_fleet_state(cfg, n, device="cpu")
    singles = [tp.init_pipeline_state(ecfg, "cpu") for _ in range(n)]
    saw_jump = False
    for t in range(T):
        fleet, outs = tfleet.fleet_step(
            fleet, tfleet.stack_frames([streams[r][t] for r in range(n)]),
            cfg, fuse_backend=backend)
        for r in range(n):
            singles[r], out = tp.step(singles[r], streams[r][t], ecfg,
                                      fuse_backend=backend)
            a = tree_leaves(singles[r])
            b = tree_leaves(tree_map(lambda x: x[r], fleet))
            for k in a:
                assert torch.equal(a[k], b[k]), (t, r, k)
            assert torch.equal(out.features.traver, outs.features.traver[r])
        saw_jump |= bool(fleet.jump_odom[1]) and not bool(fleet.jump_odom[0])
    s = fleet.submaps
    assert saw_jump
    assert int(s.num_submaps.max()) > s.counts.shape[1]        # ring wrap
    assert s.dropped.max() > 0 and len(set(s.dropped.tolist())) > 1
    assert int(s.kf_ids.max()) >= 3


def test_fleet_effective_config_describes_state_shapes():
    cfg = tconfig.benchmark_config(length=32, max_points=512)
    cfg = cfg.replace(submap=dataclasses.replace(cfg.submap,
                                                 staging_frames=4))
    fleet = tfleet.make_fleet_state(cfg, 3, device="cpu")
    eff = tfleet.fleet_effective_config(cfg)
    assert eff.submap.staging_frames == 0
    got = tree_leaves(fleet)
    want = tree_leaves(tp.init_pipeline_state(eff, "cpu"))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == (3,) + want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    bad = tree_leaves(tp.init_pipeline_state(cfg, "cpu"))
    assert any(got[k].shape != (3,) + bad[k].shape for k in got)
    # the same tree as the JAX package's fleet state
    import gem_tpu.config as jconfig

    jcfg = jconfig.benchmark_config(length=32, max_points=512)
    jcfg = jcfg.replace(submap=dataclasses.replace(jcfg.submap,
                                                   staging_frames=4))
    jstate = tp.state_from_numpy(
        jax.tree.map(np.asarray, jfleet.make_fleet_state(jcfg, 3)), "cpu")
    for k, v in tree_leaves(jstate).items():
        assert v.shape == got[k].shape and v.dtype == got[k].dtype, k


def _entry_points(tmp_path):
    cfg = tconfig.benchmark_config(length=16, max_points=64)
    ck = str(tmp_path / "ck.npz")
    tck.save_checkpoint(ck, tp.init_pipeline_state(cfg, "cpu"))
    npz = str(tmp_path / "f.npz")
    np.savez(npz, points=np.zeros((5, 3), np.float32))
    return {
        "ElevationPipeline": lambda **kw: tp.ElevationPipeline(cfg, **kw),
        "make_fleet_state": lambda **kw: tfleet.make_fleet_state(cfg, 2,
                                                                 **kw),
        "synthetic_frames": lambda **kw: treplay.synthetic_frames(cfg, 1,
                                                                  **kw),
        "pad_frame": lambda **kw: treplay.pad_frame(
            cfg, np.zeros((5, 3), np.float32), **kw),
        "load_npz_frame": lambda **kw: treplay.load_npz_frame(cfg, npz, **kw),
        "load_checkpoint": lambda **kw: tck.load_checkpoint(ck, cfg, **kw),
        "load_checkpoint_sharded": lambda **kw: tck.load_checkpoint_sharded(
            str(tmp_path / "none"), cfg, range(2), **kw),
    }


@pytest.mark.parametrize("name", ["ElevationPipeline", "make_fleet_state",
                                  "synthetic_frames", "pad_frame",
                                  "load_npz_frame", "load_checkpoint",
                                  "load_checkpoint_sharded"])
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """With CUDA hidden, every entry point called without `device` raises
    instead of building CPU state; with `device="cpu"` it runs there."""
    fn = _entry_points(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    if name != "load_checkpoint_sharded":      # nothing saved there
        fn(device="cpu")
