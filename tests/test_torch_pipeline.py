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


def _frames(cfg, n, seed, jump_at=3):
    """n synthetic frames; frame `jump_at` (3) closes a loop (pose jumps
    0.5 m, z +0.3 m), the next three hold the jumped z (the jump settles;
    with jump_at=3, frame 6 is all padding), the frame after bumps z (the
    jump finishes)."""
    fr = [f for f, _, _ in synthetic_frames(cfg, n, n_points=3000,
                                            speed=0.35, seed=seed,
                                            max_range=2.4)]
    jz = None
    for i in range(jump_at, n):
        tr = np.asarray(fr[i].track_position).copy()
        if i == jump_at:
            tr += np.array([0.5, 0.0, 0.3], np.float32)
            jz = tr[2]
            fr[i] = dataclasses.replace(fr[i], track_position=tr,
                                        loop_closure=np.ones((), bool))
            continue
        tr[0] += 0.5
        tr[2] = jz if i < jump_at + 4 else jz + 0.05
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


def _drive_both(cfg, frames, backend="stream", atol_planes=1e-5,
                events=None):
    """Step both packages over `frames`, comparing after every frame;
    returns the port's last state.  `events`, a list, gets per frame
    (jump, keyframe due, staging ring filled) as the port saw them."""
    jf = jax.jit(functools.partial(
        jstep, cfg=cfg,
        fuse_backend=backend + "_interpret" if backend in (
            "stream", "pallas") else backend,
        feature_backend="pallas_interpret"))
    js, ts = jinit(cfg), tp.init_pipeline_state(cfg, "cpu")
    saw = {"jump": False, "shed": 0, "keyframe": 0}
    S = cfg.submap.staging_frames
    for i, f in enumerate(frames):
        full = S > 0 and int(ts.submaps.staging_used) == S - 1
        js, jo = jf(js, f)
        ts, to = tp.step(ts, tp.frame_from_numpy(f, "cpu"), cfg,
                         fuse_backend=backend)
        _compare(js, ts, i, atol_planes)
        if events is not None:
            events.append((bool(ts.jump_odom), bool(to.keyframe_due), full))
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


_BRANCH_CASES = {
    # raytrace_every, staging frames, frame count, jump_at
    "jump_on_keyframe": (1, 3, 8, 3),
    "staging_full_on_keyframe": (1, 4, 10, 5),
    "raytrace_every_3": (3, 3, 8, 3),
}


@pytest.mark.parametrize("backend", ["stream", "pallas"])
@pytest.mark.parametrize("case", sorted(_BRANCH_CASES))
def test_step_branch_cases_match_jax(case, backend):
    """The frames where JAX's conds meet, each taken by a select in the
    port: a loop-closure jump on a keyframe frame (re_anchor and the
    finalize both selected, the shed suppressed), the staging ring filling
    on a keyframe frame outside a jump (its flush and the finalize's flush
    on one frame), and a raytrace every third frame."""
    every, staging, n, jump_at = _BRANCH_CASES[case]
    cfg = _cfg(every, staging)
    events = []
    _drive_both(cfg, _frames(cfg, n, seed=11 + n + jump_at, jump_at=jump_at),
                backend, events=events)
    if case == "jump_on_keyframe":
        assert any(j and k for j, k, _ in events), events
    elif case == "staging_full_on_keyframe":
        assert any(k and f and not j for j, k, f in events), events
    else:
        assert any(k for _, k, _ in events), events


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


def _port_drive(n, seed=2):
    from gem_tpu_torch.config import benchmark_config as tcfg
    from gem_tpu_torch.io.replay import synthetic_frames as tframes

    cfg = tcfg(length=32, max_points=1024)
    cfg = cfg.replace(submap=dataclasses.replace(
        cfg.submap, keyframe_distance=0.8, staging_frames=2, capacity=512,
        max_submaps=3))
    frames = [f for f, _, _ in tframes(cfg, n, n_points=900, speed=0.4,
                                       seed=seed, max_range=1.5,
                                       device="cpu")]
    return cfg, frames


def _assert_states_equal(a, b):
    from gem_tpu_torch.utils.tree import tree_leaves

    a, b = tree_leaves(a), tree_leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_pipeline_state_from_checkpoint_continues_like_step(tmp_path):
    """`ElevationPipeline.state` assigned from a checkpoint continues as
    `step` does from the same checkpoint, leaf for leaf."""
    from gem_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    cfg, frames = _port_drive(8)
    pipe = tp.ElevationPipeline(cfg, device="cpu")
    for f in frames[:4]:
        pipe.process(f)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, pipe.state)
    resumed = tp.ElevationPipeline(cfg, device="cpu")
    resumed.state, _ = load_checkpoint(path, cfg, device="cpu")
    state, _ = load_checkpoint(path, cfg, device="cpu")
    for f in frames[4:]:
        out = resumed.process(f)
        state, ref_out = tp.step(state, f, cfg)
        _assert_states_equal(resumed.state, state)
        _assert_states_equal(out, ref_out)
    assert int(state.submaps.num_submaps) >= 2


def test_pipeline_scan_steps_on_stacked_frames():
    """`ElevationPipeline.scan_steps` over a (T, ...) stacked Frame and over
    a list of Frames equals T `step` calls, state and per-frame metrics."""
    cfg, frames = _port_drive(6, seed=3)
    state = tp.init_pipeline_state(cfg, "cpu")
    rows = []
    for f in frames:
        state, out = tp.step(state, f, cfg)
        rows.append(out)
    for arg in (tp.stack_frames(frames), frames):
        pipe = tp.ElevationPipeline(cfg, device="cpu")
        m = pipe.scan_steps(arg)
        _assert_states_equal(pipe.state, state)
        assert m["keyframe"].tolist() == [bool(o.keyframe_due)
                                          for o in rows]
        for k in ("points_valid", "cells_fused", "shed_count"):
            assert m[k].tolist() == [int(o.metrics[k]) for o in rows], k
    assert any(m["keyframe"].tolist())


def test_write_back_reads_every_source_before_writing():
    """utils/graph.py `write_back`, the copy a captured step ends with: a
    source that is another buffer is read before any buffer is written, a
    source that is its own buffer is left alone, and a source of another
    shape or type is refused."""
    from gem_tpu_torch.utils.graph import write_back

    a, b, c = torch.arange(4.0), torch.arange(4.0) + 10, torch.zeros(2)
    write_back({"a": a, "b": b, "c": c}, {"a": b, "b": a, "c": c})
    assert a.tolist() == [10.0, 11.0, 12.0, 13.0]
    assert b.tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="dtype|int32|shape"):
        write_back({"a": a}, {"a": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(ValueError):
        write_back({"a": a}, {"a": torch.zeros(3)})



def test_copy_groups_copy_every_input_into_its_buffer():
    """utils/graph.py `_copy_groups`, the replay's input copy: one group a
    dtype, in the leaves' order, and a `_foreach_copy_` a group writes each
    leaf, a strided one and two leaves from one tensor included, into its
    own buffer."""
    from gem_tpu_torch.utils.graph import _copy_groups

    cloud = torch.arange(24.0).view(6, 4)
    pose = torch.arange(19.0)
    src = [cloud[:, :3], torch.tensor([True, False]), pose[:16].view(4, 4),
           torch.arange(3, dtype=torch.int32), pose[16:], pose[16:]]
    static_in = [torch.zeros_like(t, memory_format=torch.contiguous_format)
                 for t in src]
    groups = _copy_groups(static_in)
    assert [at for _, at in groups] == [[0, 2, 4, 5], [1], [3]]
    assert all(d is static_in[i] for dst, at in groups
               for d, i in zip(dst, at))
    for dst, at in groups:
        torch._foreach_copy_(dst, [src[i] for i in at])
    assert all(torch.equal(d, s) for d, s in zip(static_in, src))
