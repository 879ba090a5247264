"""The port's tracer (gem_tpu_torch/utils/observability.py `TRACER`) on the
CPU: off it records nothing; on it stamps each stage of each frame once
(the IF bodies only on the frames that take them) without changing a bit
of the step; `apply_loop_closure` records its spans once per call and
counts every read it makes; a profiler alone turns on its spans and
counters but stamps nothing, and `trace(dir)` turns it on; `program.bytes_in`
counts a replay's input bytes on the card and nothing on the CPU.  The
stamps on the card and the captured graphs' nodes are tested in
tests/test_torch_cuda.py."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from gem_tpu_torch.config import benchmark_config
from gem_tpu_torch.global_map.loop_closure import apply_loop_closure
from gem_tpu_torch.io.replay import synthetic_frames
from gem_tpu_torch.mapping.pipeline import (ElevationPipeline, batched_step,
                                            init_pipeline_state,
                                            stack_frames)
from gem_tpu_torch.utils import observability as obs
from gem_tpu_torch.utils.observability import (COLUMN, STAGES, TRACER,
                                               stage_ns, taken, trace)
from gem_tpu_torch.utils.tree import tree_leaves, tree_map

@pytest.fixture(autouse=True)
def fresh_tracer():
    TRACER.enable(False)
    TRACER.reset()
    yield TRACER
    TRACER.enable(False)
    TRACER.reset()


def _cfg():
    cfg = benchmark_config(length=64, max_points=4096)
    return cfg.replace(raytrace_every=2, submap=dataclasses.replace(
        cfg.submap, keyframe_distance=1.0, staging_frames=3, capacity=4096,
        max_submaps=4, store_ortho=True, keyframe_scan_points=64))


def _frames(cfg, n=10, seed=1):
    return [f for f, _, _ in synthetic_frames(cfg, n, n_points=3000,
                                               speed=0.35, seed=seed,
                                               max_range=2.4, device="cpu")]


def _drive(cfg, frames):
    """(pipeline, [(keyframe_due, staging flushed)] per frame)."""
    pipe = ElevationPipeline(cfg, device="cpu")
    S = cfg.submap.staging_frames
    took = []
    for f in frames:
        full = int(pipe.state.submaps.staging_used) == S - 1
        out = pipe.process(f)
        took.append((bool(out.keyframe_due), full))
    return pipe, took


def _corrected(pipe):
    opt = pipe.state.submaps.poses.clone().numpy()
    opt[:, 0] += 0.1
    return opt[:int(pipe.state.submaps.num_submaps)]


def test_off_records_nothing():
    rings = dict(TRACER._rings)       # made by earlier tests, if any
    cfg = _cfg()
    pipe, _ = _drive(cfg, _frames(cfg, 6))
    apply_loop_closure(pipe.state.submaps, cfg, _corrected(pipe))
    assert TRACER.counts == {} and TRACER.spans == {} and TRACER.log == []
    assert TRACER._rings == rings and TRACER.units == 0
    assert TRACER.advanced == {}
    assert TRACER.span("gem.x") is TRACER.unit() is obs._NULL


def test_step_is_bitwise_the_same_with_the_tracer_on():
    cfg = _cfg()
    frames = _frames(cfg, 8)
    off, _ = _drive(cfg, frames)
    outs_off = [off.last_outputs]
    with TRACER.enabled():
        on, _ = _drive(cfg, frames)
    assert TRACER.units == len(frames)
    for a, b in ((off.state, on.state), (outs_off[-1], on.last_outputs)):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert list(la) == list(lb)
        for k in la:
            assert torch.equal(la[k], lb[k]), k


def test_each_stage_is_stamped_once_per_frame(monkeypatch):
    """Every stage boundary once per frame, in the frame's order; the flush
    and finalize bodies only on the frames that take them (the CPU runs
    only the taken side), which their stamps tell apart."""
    calls = []
    real = obs.Tracer.mark

    def spy(self, stage, device):
        calls.append((self._unit[0] if self._unit else None, stage))
        return real(self, stage, device)

    monkeypatch.setattr(obs.Tracer, "mark", spy)
    cfg = _cfg()
    frames = _frames(cfg, 12)
    TRACER.enable()
    pipe, took = _drive(cfg, frames)
    assert any(k for k, _ in took) and any(f for _, f in took)
    assert any(not k and not f for k, f in took)
    ring = TRACER.ring("cpu")
    rows = TRACER.recent_rows("cpu", len(frames))
    for u, ((key, flush), r) in enumerate(zip(took, rows)):
        got = [s for unit, s in calls if unit == u]
        want = ["program.in", "move", "pointproc", "fuse", "motion",
                "features", "shed"] + ["flush"] * flush + [
                "raytrace", "keyframe"] + ["finalize"] * key + [
                "write_back", "program.out"]
        assert got == want, (u, got)
        row = ring[r]
        assert taken(row, "program.in", "flush") == flush
        assert taken(row, "program.in", "finalize") == key
        stamps = [row[COLUMN[s]] for s in want]
        assert stamps == sorted(stamps)
        assert set(stage_ns(row, "program.in")) == {
            "move", "pointproc", "fuse", "motion", "features", "raytrace",
            "submaps", "program_io"}


def test_a_fleet_stamps_both_sides_of_its_bodies():
    """R > 1 takes the select route: both sides of every branch run, so a
    fleet's bodies stamp on every frame."""
    cfg = _cfg()
    frames = _frames(cfg, 3)
    state = tree_map(lambda x: torch.stack([x, x]),
                     init_pipeline_state(cfg, "cpu"))
    TRACER.enable()
    for f in frames:
        state, _ = batched_step(state, stack_frames([f, f]), cfg)
    ring = TRACER.ring("cpu")
    for r in TRACER.recent_rows("cpu", len(frames)):
        assert taken(ring[r], "move", "flush")
        assert taken(ring[r], "move", "finalize")


@pytest.mark.parametrize("robots", [2, 1], ids=["fleet", "single"])
def test_select_routed_branches_are_counted_per_unit(robots, monkeypatch):
    """`control.selects` counts, per unit, each cond or when that took the
    select route: a 2-robot fleet's window cond, raytrace cadence and
    keyframe finalize on every fleet frame (its staging is off); one robot
    on the CPU branches and counts none.  Read as the benchmark reads it:
    the tracer off, a profiler recording."""
    from torch.profiler import ProfilerActivity, profile

    from gem_tpu_torch.multirobot.fleet import FleetPipeline
    from gem_tpu_torch.utils import control

    routes = []
    real = control.route
    monkeypatch.setattr(control, "route",
                        lambda pred: routes.append(real(pred)) or routes[-1])
    cfg = _cfg()
    frames = _frames(cfg, 4)
    if robots > 1:
        pipe = FleetPipeline(cfg, robots, device="cpu")
        frames = [stack_frames([f] * robots) for f in frames]
    else:
        pipe = ElevationPipeline(cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for f in frames:
            pipe.process(f)
    per_unit = [0] * len(frames)
    for rec in TRACER.log:
        if rec[0] == "count" and rec[1] == "control.selects":
            per_unit[rec[2]] += rec[3]
    assert TRACER.units == len(frames)
    assert sum(per_unit) == routes.count("select")
    assert per_unit == [3 if robots > 1 else 0] * len(frames)


def test_a_tally_keeps_its_counts_from_the_tracer():
    """Inside `tally()` counts go to its dict alone, the tracer on or off
    (what `DeviceProgram` keeps with a captured graph)."""
    TRACER.enable()
    with TRACER.tally() as counted:
        TRACER.count("control.selects", 2)
        TRACER.count("control.selects")
    TRACER.count("program.replays")
    assert counted == {"control.selects": 3}
    assert TRACER.counts == {"program.replays": 1}
    TRACER.enable(False)
    with TRACER.tally() as counted:
        TRACER.count("control.selects")
    TRACER.count("control.selects")
    assert counted == {"control.selects": 1}
    assert TRACER.counts == {"program.replays": 1}


def test_stage_ns_reads_its_stretches_and_drops_stale_ones():
    row = np.zeros(len(STAGES), np.int64)
    for i, s in enumerate(["program.in", "move", "pointproc", "fuse",
                           "motion", "features", "shed", "raytrace",
                           "keyframe", "write_back", "program.out"]):
        row[COLUMN[s]] = 100 + 10 * i
    got = stage_ns(row, "program.in")
    assert got == {"move": 10, "pointproc": 10, "fuse": 10, "motion": 10,
                   "features": 10, "raytrace": 10, "submaps": 10 + 10,
                   "program_io": 10 + 10}
    assert sum(got.values()) == row[COLUMN["program.out"]] - 100
    row[COLUMN["keyframe"]] = 5          # an older unit's stamp
    assert set(stage_ns(row, "program.in")) == {
        "move", "pointproc", "fuse", "motion", "features", "program_io"}


class _Reads(TorchFunctionMode):
    """Counts device->host reads: `.cpu()`, and conversions to Python or
    NumPy of a tensor that no `.cpu()` just returned; and the uploads (a
    tensor made from a NumPy array)."""

    def __init__(self):
        super().__init__()
        self.reads = self.uploads = 0
        self.fetched = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name == "cpu":
            self.reads += 1
            self.fetched.add(id(out))
        elif name in ("item", "tolist", "numpy", "__int__", "__float__",
                      "__bool__", "__index__"):
            if id(args[0]) in self.fetched:
                self.fetched.discard(id(args[0]))
            else:
                self.reads += 1
        elif name == "from_numpy" or (
                name in ("as_tensor", "tensor")
                and isinstance(args[0], np.ndarray)):
            self.uploads += 1
        return out


def test_apply_loop_closure_spans_and_reads():
    cfg = _cfg()
    pipe, _ = _drive(cfg, _frames(cfg, 12))
    store = pipe.state.submaps
    TRACER.enable()
    TRACER.reset()
    opts = [_corrected(pipe) + np.float32(s) for s in (0.1, 0.2)]
    stats = []
    with _Reads() as seen:
        for opt in opts:
            stats.append(apply_loop_closure(store, cfg, opt)[1])
    assert all(s["n_pairs"] > 0 for s in stats)
    calls = {k: v[0] for k, v in TRACER.spans.items()}
    for name in ("apply", "corrections", "transform", "select_pairs",
                 "schedule", "refuse"):
        assert calls[f"gem.restitch.{name}"] == 2, (name, calls)
    assert calls["gem.restitch.round"] == sum(s["n_rounds"] for s in stats)
    assert TRACER.counts["restitch.reads"] == seen.reads == 10
    assert calls["gem.restitch.read"] == 10
    assert TRACER.counts["restitch.uploads"] == seen.uploads == 10
    assert TRACER.units == 2
    ring = TRACER.ring("cpu")
    for r in TRACER.recent_rows("cpu", 2):
        assert stage_ns(ring[r], "refuse")["refuse"] > 0


def test_a_profiler_alone_turns_on_spans_and_counts():
    """With the tracer off, a profiler's block logs the program's spans
    (as CPU operations of the profile too) and counts, each with its unit,
    and stamps nothing; the same calls before and after it record
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    frames = _frames(cfg, 12)
    pipe, _ = _drive(cfg, frames[:8])
    assert TRACER.spans == {} and TRACER.log == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in frames[8:10]:
            pipe.process(f)
        apply_loop_closure(pipe.state.submaps, cfg, _corrected(pipe))
    pipe.process(frames[10])
    assert {r[2] for r in TRACER.log} == {0, 1, 2}
    units = [r[2] for r in TRACER.log
             if r[0] == "span" and r[1] == "gem.program.replay"]
    assert units == [0, 1]
    assert sum(r[3] for r in TRACER.log if r[0] == "count"
               and r[1] == "restitch.reads" and r[2] == 2) == 5
    assert {r[0] for r in TRACER.log} == {"span", "count"}
    assert TRACER.advanced == {}
    assert TRACER.spans["gem.program.replay"][0] == 2
    names = {e.name for e in prof.events()}
    assert {"gem.program.replay", "gem.restitch.apply",
            "gem.restitch.read"} <= names


def test_trace_dir_turns_the_tracer_on(tmp_path):
    cfg = _cfg()
    frames = _frames(cfg, 2)
    pipe = ElevationPipeline(cfg, device="cpu")
    with trace(str(tmp_path)):
        assert TRACER.on
        for f in frames:
            pipe.process(f)
    assert not TRACER.on
    assert TRACER.spans["gem.program.replay"][0] == 2
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gem.program.copy_in", "gem.program.replay",
            "gem.program.copy_out"} <= names
    with trace(""):
        assert not TRACER.on


def test_marks_outside_a_unit_stamp_nothing():
    """Nor while the tracer is off, a profiler recording or not."""
    from torch.profiler import ProfilerActivity, profile

    TRACER.mark("move", "cpu")
    with profile(activities=[ProfilerActivity.CPU]), TRACER.unit():
        TRACER.mark("move", "cpu")          # a profiler alone: no stamp
    TRACER.enable()
    TRACER.mark("move", "cpu")
    assert TRACER.advanced == {} and TRACER.units == 1
    TRACER.reset()
    with TRACER.unit():
        TRACER.mark("refuse", "cpu")
        with TRACER.unit():             # joins the open unit
            TRACER.mark("refused", "cpu")
    assert TRACER.units == 1 and TRACER.advanced == {torch.device("cpu"): 1}
    row = TRACER.ring("cpu")[0]
    assert row[COLUMN["refused"]] >= row[COLUMN["refuse"]] > 0


def test_reset_zeroes_the_ring_in_place():
    """A captured graph holds the ring's address: `reset` keeps the ring
    and the row counter where they are, zeroed, and the rows start over."""
    TRACER.enable()
    for _ in range(3):
        with TRACER.unit():
            TRACER.mark("refuse", "cpu")
    ring, counter = TRACER._rings[torch.device("cpu")]
    at = (ring.data_ptr(), counter.data_ptr())
    assert TRACER.recent_rows("cpu", 5) == [0, 1, 2]
    TRACER.reset()
    assert TRACER._rings[torch.device("cpu")] == (ring, counter)
    assert (ring.data_ptr(), counter.data_ptr()) == at
    assert not ring.any() and not counter.any()
    assert TRACER.recent_rows("cpu", 5) == [] and TRACER.units == 0
    with TRACER.unit():
        TRACER.mark("refuse", "cpu")
    assert TRACER.recent_rows("cpu", 5) == [0] and ring[0].any()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bytes_in_counts_the_inputs_once_per_replay(device):
    """`program.bytes_in`: on the card, each replay counts the bytes it
    copies into the graph's static inputs (every input leaf's `nbytes`),
    per unit, as the benchmark reads it (the tracer off, a profiler
    recording); the eager first call, which captures, copies none.  The
    CPU copies nothing and counts nothing."""
    from torch.profiler import ProfilerActivity, profile

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    cfg = _cfg()
    frames = [tree_map(lambda t: t.to(device), f) for f in _frames(cfg, 4)]
    pipe = ElevationPipeline(cfg, device=device)
    with profile(activities=[ProfilerActivity.CPU]):
        for f in frames:
            pipe.process(f)
    per_unit = [0] * len(frames)
    for rec in TRACER.log:
        if rec[0] == "count" and rec[1] == "program.bytes_in":
            per_unit[rec[2]] += rec[3]
    nbytes = sum(t.nbytes for t in tree_leaves(frames[0]).values())
    if device == "cpu":
        assert per_unit == [0] * len(frames)
        assert "program.bytes_in" not in TRACER.counts
    else:
        assert per_unit == [0] + [nbytes] * (len(frames) - 1), per_unit
        assert nbytes > 4096 * (12 + 4 + 1 + 4)
