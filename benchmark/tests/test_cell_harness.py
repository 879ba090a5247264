"""Whole runs of each cell at a tiny size, the harness's look for a card
skipped: sound runs come out correct, and each fault that a cell can have,
planted under the timed path, and the control come out not correct.

Faults: a step that returns its state unchanged; half of each frame's
points left out; an answer altered where it is produced (one map cell, one
re-stitched point); for the re-stitch also half of its pairs left out.
The cells run on one card, so there is no exchange between cards to leave
out."""

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import make_root

FRAME_CELLS = ["hdl64_100m.online", "kitti_demo.online",
               "hdl64_100m.replay", "hdl64_100m.restitch"]
SEED = 2 ** 31 + 17


def _run(root, cell, device="cpu", control=False, seconds=1.5):
    return harness.run_cell(root, cell, SEED, seconds, False, device,
                            control=control)


@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_traced_run_is_correct(tiny_root, cell):
    out = harness.run_cell(tiny_root, cell, SEED + 1, 4.0, True, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", ["hdl64_100m.online", "kitti_demo.online",
                                  "hdl64_100m.restitch"])
def test_control_is_not_correct(tiny_root, cell):
    assert not _run(tiny_root, cell, control=True)["correct"]


def _unchanged(real):
    def step(state, frame, cfg, fuse_backend="stream"):
        _, out = real(state, frame, cfg, fuse_backend)
        return state, out
    return step


def _half_batch(real):
    def step(state, frame, cfg, fuse_backend="stream"):
        P = frame.valid.shape[-1]
        keep = torch.arange(P, device=frame.valid.device) < P // 2
        return real(state, dataclasses.replace(
            frame, valid=frame.valid & keep), cfg, fuse_backend)
    return step


def _altered(real):
    def step(state, frame, cfg, fuse_backend="stream"):
        new, out = real(state, frame, cfg, fuse_backend)
        elev = new.map.elevation.clone()
        ok = elev != cfg.map.invalid_elevation
        if ok.any():
            i = int(ok.flatten().nonzero()[0])
            elev.view(-1)[i] += 0.01
        return new.replace(map=new.map.replace(elevation=elev)), out
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["hdl64_100m.online", "kitti_demo.online",
                                  "hdl64_100m.replay"])
def test_step_fault_is_caught(tiny_root, cell, fault, monkeypatch):
    from gem_tpu_torch.mapping import pipeline

    monkeypatch.setattr(pipeline, "step", fault(pipeline.step))
    assert not _run(tiny_root, cell)["correct"]


def _store_unchanged(real):
    def apply(store, cfg, opt):
        _, stats = real(store, cfg, opt)
        return store, stats
    return apply


def _store_altered(real):
    def apply(store, cfg, opt):
        new, stats = real(store, cfg, opt)
        z = new.slots.z.clone()
        z[1, 0] += 0.01
        return new.replace(slots=new.slots.replace(z=z)), stats
    return apply


@pytest.mark.parametrize("fault", ["unchanged", "half_pairs", "altered"])
def test_restitch_fault_is_caught(tiny_root, fault, monkeypatch):
    from gem_tpu_torch.global_map import loop_closure

    if fault == "half_pairs":
        real = loop_closure.select_pairs
        monkeypatch.setattr(loop_closure, "select_pairs",
                            lambda *a: real(*a)[::2])
    else:
        wrap = _store_unchanged if fault == "unchanged" else _store_altered
        monkeypatch.setattr(loop_closure, "apply_loop_closure",
                            wrap(loop_closure.apply_loop_closure))
    assert not _run(tiny_root, "hdl64_100m.restitch")["correct"]


def test_loose_limits_pass_and_none_fail(tmp_path):
    """The limits decide: a tiny root whose limits are all infinite passes
    the altered answer; the judged numbers are the cell's own."""
    root = make_root(str(tmp_path), limits=float("inf"))
    out = _run(root, "hdl64_100m.online")
    assert out["correct"]
    assert set(out["checks"]) == {"elevation_gap_m", "variance_gap_rel",
                                  "feature_gap", "store_gap", "int_mismatch"}


def test_on_the_card(cuda, tiny_root):
    out = _run(tiny_root, "hdl64_100m.online", device=cuda)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_raw_intake_needs_the_native_filter(tiny_root, monkeypatch):
    """Without the native library `pad_frame` would time its NumPy
    fallback: the run stops in set-up instead."""
    from gem_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native voxel filter"):
        _run(tiny_root, "kitti_demo.online")
