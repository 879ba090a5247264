"""utils/control.py, the port's `lax.cond`, on the CPU.

A CPU predicate of one element takes the branch route: only the taken side
runs, as JAX on the CPU.  A predicate with a robot axis (R > 1) takes the
select route: both sides run and `torch.where` keeps the taken one, as
JAX's cond under `vmap`.  The single-robot `step` (branch route) and
`batched_step` over two copies of the robot (select route) must agree bit
for bit in every leaf, on the frames where the step's four conds meet
(tests/test_torch_pipeline.py `_BRANCH_CASES`).  The CUDA-graph route is
tested on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from gem_tpu.mapping.pipeline import init_pipeline_state as jinit
from gem_tpu.mapping.pipeline import step as jstep

from gem_tpu_torch.global_map import submaps as sm
from gem_tpu_torch.mapping import pipeline as tp
from gem_tpu_torch.utils import control
from gem_tpu_torch.utils.tree import tree_leaves, tree_map

from test_torch_pipeline import _BRANCH_CASES, _cfg, _frames


def _recorder(log, name, fn):
    def side(*args, **kw):
        log.append(name)
        return fn(*args, **kw)
    side.__name__ = name
    return side


@pytest.mark.parametrize("taken", [True, False])
def test_cond_and_when_run_only_the_taken_side(taken):
    log = []
    x = torch.arange(4.0)
    pred = torch.tensor(taken)
    got = control.cond(pred, _recorder(log, "double", lambda v: (v * 2,)),
                       _recorder(log, "negate", lambda v: (-v,)), x)
    assert log == ["double" if taken else "negate"]
    assert torch.equal(got[0], x * 2 if taken else -x)

    def bump(store, when=None):
        assert when is None            # the branch route: the in-place form
        store["n"].add_(1)
        return store

    store = {"n": torch.zeros((), dtype=torch.int32)}
    log.clear()
    out = control.when(pred.reshape(1), _recorder(log, "bump", bump), store)
    assert out is store and int(store["n"]) == int(taken)
    assert log == (["bump"] if taken else [])


@pytest.mark.parametrize("pred", [True, [True, False]],
                         ids=["branch", "select"])
def test_when_refuses_a_branch_that_is_not_in_place(pred):
    """A body that returns new tensors fails on the branch route (a () CPU
    predicate) and on the select route (a (2,) one) alike."""
    pred = torch.tensor(pred)

    def fresh(store, when=None):
        return {"n": store["n"] + 1}

    with pytest.raises(control.BranchError, match="in place"):
        control.when(pred, fresh, {"n": torch.zeros(pred.shape)})


def test_robot_axis_selects_as_per_robot_branching():
    """R = 2: both sides run once for both robots and each robot gets its
    own side, as cond robot by robot; `when` calls the masked form."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
    pred = torch.tensor([True, False])
    log = []
    tf = _recorder(log, "t", lambda v: {"a": v.exp(), "b": v.sum(-1)})
    ff = _recorder(log, "f", lambda v: {"a": v * 3, "b": v.amax(-1)})
    got = control.cond(pred, tf, ff, x)
    assert sorted(log) == ["f", "t"]
    for r in range(2):
        ref = control.cond(pred[r], tf, ff, x[r])
        for k in ("a", "b"):
            assert torch.equal(got[k][r], ref[k]), (r, k)

    seen = []

    def bump(store, when=None):
        seen.append(when)
        control.assign(when, store["n"], store["n"] + 1)
        return store

    store = {"n": torch.zeros(2, dtype=torch.int32)}
    out = control.when(pred, bump, store)
    assert out is store and store["n"].tolist() == [1, 0]
    assert seen[0] is pred
    assert control.route(pred) == "select"
    assert control.route(pred[:1]) == control.route(pred[0]) == "branch"


def _spy(monkeypatch, module, name, log):
    fn = getattr(module, name)

    def spy(*args, **kw):
        log.append((name, kw.get("when") is None))
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("case", sorted(_BRANCH_CASES))
def test_step_branches_equal_the_select_route_bitwise(case, monkeypatch):
    """`step` (one robot: only the taken sides run) against `batched_step`
    on two stacked copies of the robot (both sides and a select): every
    state leaf and every output bitwise after every frame, for both
    copies.  Spies count what ran: on the branch route re_anchor only on
    jump frames and move on the others, the raytrace only on due frames,
    the finalize (in place) only on keyframe frames."""
    every, staging, n, jump_at = _BRANCH_CASES[case]
    cfg = _cfg(every, staging)
    frames = [tp.frame_from_numpy(f, "cpu")
              for f in _frames(cfg, n, seed=11 + n + jump_at,
                               jump_at=jump_at)]
    log = []
    for name in ("re_anchor", "move", "raytrace_cleanup"):
        _spy(monkeypatch, tp, name, log)
    _spy(monkeypatch, sm, "finalize_submap", log)
    one = tp.init_pipeline_state(cfg, "cpu")
    two = tree_map(lambda x: torch.stack([x, x]),
                   tp.init_pipeline_state(cfg, "cpu"))
    S = cfg.submap.staging_frames
    events = []
    for i, f in enumerate(frames):
        due = int(one.frame_idx) % every == 0
        full = int(one.submaps.staging_used) == S - 1
        log.clear()
        one, out = tp.step(one, f, cfg)
        ran = sorted(log)
        jump, key = bool(one.jump_odom), bool(out.keyframe_due)
        want = sorted([("re_anchor" if jump else "move", True)]
                      + [("raytrace_cleanup", True)] * due
                      + [("finalize_submap", True)] * key)
        assert ran == want, (i, ran, want)
        log.clear()
        two, outs = tp.batched_step(two, tp.stack_frames([f, f]), cfg)
        assert ("finalize_submap", False) in log and ("re_anchor", True) \
            in log and ("move", True) in log, log
        for r in range(2):
            pick = functools.partial(tree_map, lambda x: x[r])
            for a, b, what in ((one, pick(two), "state"),
                               (out, pick(outs), "outputs")):
                la, lb = tree_leaves(a), tree_leaves(b)
                bad = [k for k in la if not torch.equal(la[k], lb[k])]
                assert not bad, (i, r, what, bad)
        events.append((jump, key, full))
    if case == "jump_on_keyframe":
        assert any(j and k for j, k, _ in events), events
    elif case == "staging_full_on_keyframe":
        assert any(k and f and not j for j, k, f in events), events
    else:
        assert any(k for _, k, _ in events), events


def test_keyframe_payload_matches_jax():
    """store_ortho=True and keyframe_scan_points > 0: the finalize branch
    stores the orthomosaic and the raw keyframe scan; after every frame the
    rings and their keys equal JAX's step exactly (the planes themselves
    are held by tests/test_torch_pipeline.py)."""
    cfg = _cfg(store_ortho=True, keyframe_scan_points=64)
    rng = np.random.default_rng(5)
    frames = [dataclasses.replace(f, colors=rng.integers(
        1, 1 << 24, f.colors.shape).astype(np.int32))
        for f in _frames(cfg, 7, seed=5)]
    jf = jax.jit(functools.partial(jstep, cfg=cfg,
                                   fuse_backend="stream_interpret",
                                   feature_backend="pallas_interpret"))
    js, ts = jinit(cfg), tp.init_pipeline_state(cfg, "cpu")
    keyframes = 0
    for i, f in enumerate(frames):
        js, jo = jf(js, f)
        ts, to = tp.step(ts, tp.frame_from_numpy(f, "cpu"), cfg)
        keyframes += bool(to.keyframe_due)
        a = jax.tree.map(np.asarray, js.submaps)
        for k in ("orthos", "kf_points", "kf_counts", "poses", "centers",
                  "kf_ids", "counts", "num_submaps"):
            np.testing.assert_array_equal(getattr(ts.submaps, k).numpy(),
                                          getattr(a, k), err_msg=f"{i} {k}")
        np.testing.assert_array_equal(ts.last_keyframe_xy.numpy(),
                                      np.asarray(js.last_keyframe_xy))
    assert keyframes >= 2 and int(ts.submaps.kf_counts.sum()) > 0
    assert int(ts.submaps.orthos.sum()) > 0
