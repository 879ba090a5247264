"""The whole slice: the port's per-frame `step` against gem_tpu's
`step(fuse_backend=..., feature_backend="pallas_interpret")` (Pallas
kernels in interpret mode) over frames that include a loop-closure jump and
an all-padding frame: the shipped accelerator configuration
(`stream_interpret`), and the segment, sort and pallas backends.

Tolerances, per plane after every frame: elevation and variance 1e-5 (f32
sums of each cell's run in another order, carried across frames; 1e-4 for
the sort backend, whose sums are a global cumsum minus the carry at each
run start and so carry the rounding of the whole prefix, see
test_torch_fuse.py); traver 1e-3 (acos/cos differ by an ULP between XLA
and PyTorch on the CPU, which near-flat cells amplify, see
test_torch_features.py); lowest 1e-6; color, intensity, start, center, the
jump state and the submap counters exactly.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from gem_tpu.config import benchmark_config
from gem_tpu.io.replay import synthetic_frames
from gem_tpu.mapping.pipeline import init_pipeline_state as jinit
from gem_tpu.mapping.pipeline import step as jstep

from gem_tpu_torch.mapping import pipeline as tp


def _frames(cfg, n, seed):
    """n synthetic frames; frame 3 closes a loop (pose jumps 0.5 m, z
    +0.3 m), frames 4-5 hold the jumped z (the jump settles), frame 6 is
    all padding, frame 7 bumps z (the jump finishes)."""
    fr = [f for f, _, _ in synthetic_frames(cfg, n, n_points=3000,
                                            speed=0.35, seed=seed,
                                            max_range=2.4)]
    jz = None
    for i in range(3, n):
        tr = np.asarray(fr[i].track_position).copy()
        if i == 3:
            tr += np.array([0.5, 0.0, 0.3], np.float32)
            jz = tr[2]
            fr[i] = dataclasses.replace(fr[i], track_position=tr,
                                        loop_closure=np.ones((), bool))
            continue
        tr[0] += 0.5
        tr[2] = jz if i < 7 else jz + 0.05
        fr[i] = dataclasses.replace(fr[i], track_position=tr)
    fr[6] = dataclasses.replace(fr[6], valid=np.zeros_like(fr[6].valid))
    return fr


def _compare(js, ts, i, atol_planes=1e-5):
    a = jax.tree.map(np.asarray, js)
    b = tp.state_to_numpy(ts)
    for k, atol in (("elevation", atol_planes), ("variance", atol_planes),
                    ("lowest", 1e-6), ("traver", 1e-3)):
        np.testing.assert_allclose(getattr(b.map, k), getattr(a.map, k),
                                   rtol=0, atol=atol, err_msg=f"{i} {k}")
    for k in ("color", "intensity", "start", "center", "sensor_z"):
        np.testing.assert_array_equal(getattr(b.map, k), getattr(a.map, k),
                                      err_msg=f"{i} {k}")
    for k in ("jump_odom", "jump_count", "frame_idx", "last_keyframe_xy"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                      err_msg=f"{i} {k}")
    for k in ("num_submaps", "accum_count", "counts", "dropped",
              "staging_used", "kf_ids", "orthos"):
        np.testing.assert_array_equal(getattr(b.submaps, k),
                                      getattr(a.submaps, k),
                                      err_msg=f"{i} {k}")


def _drive_both(cfg, frames, backend="stream", atol_planes=1e-5):
    """Step both packages over `frames`, comparing after every frame;
    returns the port's last state and what the drive went through."""
    jf = jax.jit(functools.partial(
        jstep, cfg=cfg,
        fuse_backend=backend + "_interpret" if backend in (
            "stream", "pallas") else backend,
        feature_backend="pallas_interpret"))
    js, ts = jinit(cfg), tp.init_pipeline_state(cfg, "cpu")
    saw = {"jump": False, "shed": 0, "keyframe": 0}
    for i, f in enumerate(frames):
        js, jo = jf(js, f)
        ts, to = tp.step(ts, tp.frame_from_numpy(f, "cpu"), cfg,
                         fuse_backend=backend)
        _compare(js, ts, i, atol_planes)
        for k in ("points_valid", "cells_fused", "shed_count",
                  "index_shift"):
            np.testing.assert_array_equal(to.metrics[k].numpy(),
                                          np.asarray(jo.metrics[k]),
                                          err_msg=f"{i} {k}")
        np.testing.assert_allclose(float(to.metrics["var_update"]),
                                   float(jo.metrics["var_update"]),
                                   atol=1e-9)
        assert bool(to.keyframe_due) == bool(jo.keyframe_due)
        saw["jump"] |= bool(ts.jump_odom)
        saw["shed"] += int(to.metrics["shed_count"])
        saw["keyframe"] += int(to.keyframe_due)
    assert int(to.metrics["cells_fused"]) > 200
    assert saw["jump"] and saw["shed"] > 0 and saw["keyframe"] > 0
    assert not bool(ts.jump_odom)          # the jump settled and finished
    return ts


def _cfg(raytrace_every=1, staging=3, **submap):
    base = benchmark_config(length=48, max_points=4096)
    return base.replace(
        raytrace_every=raytrace_every,
        submap=dataclasses.replace(base.submap, keyframe_distance=1.0,
                                   staging_frames=staging, capacity=4096,
                                   max_submaps=4, **submap))


@pytest.mark.parametrize("raytrace_every,staging", [(1, 3), (2, 0)])
def test_step_matches_jax_stream_pallas(raytrace_every, staging):
    cfg = _cfg(raytrace_every, staging)
    _drive_both(cfg, _frames(cfg, 8, seed=raytrace_every))


@pytest.mark.parametrize("backend", ["segment", "sort", "pallas"])
def test_step_matches_jax_fuse_backends(backend):
    """The non-stream backends: pointproc computes `lowest`, then
    kernels/fuse.py fuses (K3's plain version on the pallas path)."""
    cfg = _cfg()
    _drive_both(cfg, _frames(cfg, 8, seed=4), backend,
                atol_planes=1e-4 if backend == "sort" else 1e-5)


def test_state_round_trip_and_handover_from_jax():
    """A JAX state after two frames, handed to the port, continues like the
    JAX step; state_to_numpy / state_from_numpy round-trip exactly."""
    cfg = benchmark_config(length=32, max_points=1024)
    frames = [f for f, _, _ in synthetic_frames(cfg, 4, n_points=900,
                                                speed=0.4, seed=6,
                                                max_range=1.5)]
    jf = jax.jit(functools.partial(jstep, cfg=cfg,
                                   fuse_backend="stream_interpret",
                                   feature_backend="pallas_interpret"))
    js = jinit(cfg)
    for f in frames[:2]:
        js, _ = jf(js, f)
    ts = tp.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    _compare(js, ts, "handover")
    back = tp.state_from_numpy(tp.state_to_numpy(ts), "cpu")
    assert torch.equal(back.map.elevation, ts.map.elevation)
    assert back.submaps.staging.valid.dtype == torch.bool
    for f in frames[2:]:
        js, _ = jf(js, f)
        ts, _ = tp.step(ts, tp.frame_from_numpy(f, "cpu"), cfg)
    _compare(js, ts, "continued")


def test_pipeline_and_scan_steps_agree():
    from gem_tpu_torch.config import benchmark_config as tcfg
    from gem_tpu_torch.io.replay import synthetic_frames as tframes

    cfg = tcfg(length=32, max_points=1024)
    frames = [f for f, _, _ in tframes(cfg, 4, n_points=900, speed=0.4,
                                       seed=2, max_range=1.5, device="cpu")]
    pipe = tp.ElevationPipeline(cfg, device="cpu")
    for f in frames:
        out = pipe.process(f)
    assert pipe.last_outputs is out
    state, m = tp.scan_steps(tp.init_pipeline_state(cfg, "cpu"), frames, cfg)
    assert m["points_valid"].shape == (4,) and int(state.frame_idx) == 4
    assert torch.equal(state.map.elevation, pipe.state.map.elevation)
    assert int(m["cells_fused"][-1]) == int(out.metrics["cells_fused"]) > 0


def test_store_ortho_matches_jax():
    """A store_ortho=True config: the keyframe finalize stores the
    orthomosaic, and the `orthos` ring equals JAX's (compared with every
    other leaf after each frame), including across a state hand-over."""
    cfg = _cfg(store_ortho=True, keyframe_scan_points=64)
    rng = np.random.default_rng(5)
    frames = [dataclasses.replace(f, colors=rng.integers(
        1, 1 << 24, f.colors.shape).astype(np.int32))
        for f in _frames(cfg, 8, seed=5)]
    ts = _drive_both(cfg, frames)
    assert ts.submaps.orthos.shape == (4, 48, 48, 3)
    assert int(ts.submaps.orthos.sum()) > 0
    back = tp.state_from_numpy(tp.state_to_numpy(ts), "cpu")
    assert torch.equal(back.submaps.orthos, ts.submaps.orthos)
    with pytest.raises(ValueError, match="fuse_backend"):
        tp.ElevationPipeline(cfg, device="cpu", fuse_backend="auto")
