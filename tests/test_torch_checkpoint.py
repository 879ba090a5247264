"""Checkpoints in the JAX npz schema (gem_tpu_torch/io/checkpoint.py): a
JAX checkpoint resumes in the port and the reverse, and the next step
matches (tolerances of tests/test_torch_pipeline.py: planes 1e-5, traver
1e-3, lowest 1e-6, the rest exactly).
"""

import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from gem_tpu.config import benchmark_config
from gem_tpu.io import checkpoint as jck
from gem_tpu.io.replay import synthetic_frames
from gem_tpu.mapping.pipeline import init_pipeline_state as jinit
from gem_tpu.mapping.pipeline import step as jstep

from gem_tpu_torch.io import checkpoint as tck
from gem_tpu_torch.mapping import pipeline as tp

from test_torch_pipeline import _compare


def _setup(store_ortho=False):
    base = benchmark_config(length=32, max_points=1024)
    cfg = base.replace(submap=dataclasses.replace(
        base.submap, keyframe_distance=0.5, max_submaps=3, capacity=2048,
        staging_frames=2, store_ortho=store_ortho))
    frames = [f for f, _, _ in synthetic_frames(cfg, 4, n_points=900,
                                                speed=0.4, seed=6,
                                                max_range=1.5)]
    jf = jax.jit(functools.partial(jstep, cfg=cfg, fuse_backend="segment",
                                   feature_backend="pallas_interpret"))
    tf = lambda s, f: tp.step(s, tp.frame_from_numpy(f, "cpu"), cfg,
                              fuse_backend="segment")
    return cfg, frames, jf, tf


@pytest.mark.parametrize("store_ortho", [False, True])
def test_jax_checkpoint_resumes_in_port(tmp_path, store_ortho):
    cfg, frames, jf, tf = _setup(store_ortho)
    js = jinit(cfg)
    for f in frames[:3]:
        js, _ = jf(js, f)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, js, extra={"note": np.int32(7)})
    ts, extra = tck.load_checkpoint(path, cfg, device="cpu")
    assert int(extra["note"]) == 7 and int(ts.frame_idx) == 3
    assert int(ts.submaps.num_submaps) >= 1
    _compare(js, ts, "loaded")
    js, _ = jf(js, frames[3])
    ts, _ = tf(ts, frames[3])
    _compare(js, ts, "next step")


def test_port_checkpoint_resumes_in_jax(tmp_path):
    cfg, frames, jf, tf = _setup(store_ortho=True)
    ts = tp.init_pipeline_state(cfg, "cpu")
    for f in frames[:3]:
        ts, _ = tf(ts, f)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, ts)
    js, _ = jck.load_checkpoint(path, cfg)
    _compare(js, ts, "loaded")
    back, _ = tck.load_checkpoint(path, cfg, device="cpu")
    for a, b in zip(tck._flatten(back).values(), tck._flatten(ts).values()):
        np.testing.assert_array_equal(a, b)
    js, _ = jf(js, frames[3])
    ts, _ = tf(ts, frames[3])
    _compare(js, ts, "next step")


def test_missing_leaves(tmp_path):
    cfg, frames, _, tf = _setup()
    ts = tp.init_pipeline_state(cfg, "cpu")
    for f in frames[:3]:
        ts, _ = tf(ts, f)
    flat = tck._flatten(ts)
    old = {k: v for k, v in flat.items() if not k.endswith("kf_ids")}
    np.savez(tmp_path / "old.npz", **old)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, _ = tck.load_checkpoint(str(tmp_path / "old.npz"), cfg,
                                  device="cpu")
    assert any("kf_ids" in str(x.message) for x in w)
    assert torch.equal(got.submaps.kf_ids, ts.submaps.kf_ids)
    bad = {k: v for k, v in flat.items() if k != "map/elevation"}
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(KeyError, match="map/elevation"):
        tck.load_checkpoint(str(tmp_path / "bad.npz"), cfg, device="cpu")
