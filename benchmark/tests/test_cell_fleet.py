"""The fleet cell (`fleet4_hdl64_100m.online`: four robots through
`FleetPipeline`) at a tiny size on the CPU, the harness's look for a card
skipped: sound and traced runs come out correct with every fleet reader
reporting, and the control and each fault planted in the batched step come
out not correct.

Faults: one robot's state left as it was; two robots' frames swapped; half
of one robot's points left out; one map cell of robot 3 altered."""

import dataclasses

import pytest
import torch

from benchmark import harness, tracing, yardstick

CELL = "fleet4_hdl64_100m.online"
SEED = 2 ** 31 + 29
READERS = ("select_branches.fleet", "device_ms_per_frame.fleet",
           "k1_roofline.fleet", "k2_roofline.fleet")


def _run(root, control=False):
    return harness.run_cell(root, CELL, SEED, 0.5, False, "cpu",
                            control=control)


def test_sound_run_is_correct(tiny_root):
    out = _run(tiny_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"frame_ms_p95", "setup_s"}


def test_traced_run_reports_the_fleet_readers(tiny_root, monkeypatch):
    """The CPU has no kernel events, so the trace is given one K1 and one
    K2 launch of 1 us per fleet frame; the work they are held to is each
    robot's, summed (four 128 x 128 maps)."""
    traces = []
    real = tracing.Recorder.trace

    def trace(self, units):
        t = real(self, units)
        lo = t.slice_us[0]
        t.device += [(s, lo + u, lo + u + 1.0) for u in range(units)
                     for s in (yardstick.K1_SYMBOL, yardstick.K2_SYMBOL)]
        traces.append(t)
        return t

    monkeypatch.setattr(tracing.Recorder, "trace", trace)
    out = harness.run_cell(tiny_root, CELL, SEED + 1, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(READERS) <= set(got), got
    # the window cond and the keyframe finalize (staging off, raytrace
    # every frame)
    assert got["select_branches.fleet"]["value"] == 2
    assert got["k1_roofline.fleet"]["value"] > 0
    assert got["k2_roofline.fleet"]["value"] > 0
    (t,) = traces
    assert len(t.work) == t.units
    assert all(w["k1"][0] == w["k2"][0] == 4 * 128 * 128 for w in t.work)


def test_control_is_not_correct(tiny_root):
    assert not _run(tiny_root, control=True)["correct"]


def _one_robot_unchanged(real):
    def step(state, frame, cfg, fuse_backend="stream"):
        from gem_tpu_torch.utils.tree import tree_map

        old = tree_map(torch.clone, state)
        new, out = real(state, frame, cfg, fuse_backend)
        return tree_map(lambda n, o: torch.cat([n[:1], o[1:2], n[2:]]),
                        new, old), out
    return step


def _frames_swapped(real):
    def step(state, frame, cfg, fuse_backend="stream"):
        from gem_tpu_torch.utils.tree import tree_map

        order = torch.tensor([1, 0, 2, 3])
        return real(state, tree_map(lambda x: x[order], frame), cfg,
                    fuse_backend)
    return step


def _half_of_one_robot(real):
    def step(state, frame, cfg, fuse_backend="stream"):
        P = frame.valid.shape[-1]
        valid = frame.valid.clone()
        valid[2, P // 2:] = False
        return real(state, dataclasses.replace(frame, valid=valid), cfg,
                    fuse_backend)
    return step


def _one_cell_of_robot_3(real):
    def step(state, frame, cfg, fuse_backend="stream"):
        new, out = real(state, frame, cfg, fuse_backend)
        elev = new.map.elevation.clone()
        ok = elev[3] != cfg.map.invalid_elevation
        if ok.any():
            i = int(ok.flatten().nonzero()[0])
            elev[3].view(-1)[i] += 0.01
        return new.replace(map=new.map.replace(elevation=elev)), out
    return step


@pytest.mark.parametrize("fault", [_one_robot_unchanged, _frames_swapped,
                                   _half_of_one_robot, _one_cell_of_robot_3],
                         ids=["robot_unchanged", "frames_swapped",
                              "half_of_one_robot", "one_cell_of_robot_3"])
def test_fault_is_caught(tiny_root, fault, monkeypatch):
    from gem_tpu_torch.multirobot import fleet

    monkeypatch.setattr(fleet, "batched_step", fault(fleet.batched_step))
    assert not _run(tiny_root)["correct"]
