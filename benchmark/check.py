"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (benchmark/reference/), number by number.

The program's state after a frame depends on every frame before it, and
the reference cannot replay a whole window in the time a run allows.  So
the reference follows the program step by step: for each checked frame it
starts from the program's own state before that frame (a host snapshot
taken in the window) and runs the same inputs; the program's state and
outputs after the frame are compared with the reference's.  The start is
checked by itself: the reference runs the warm-up frames from its own
fresh state, and its state is compared with the program's after them.

Each number is the largest gap over every checked frame or event:

  elevation_gap_m   |elevation|, |lowest| planes of the map (m)
  variance_gap_rel  |variance| / max(|reference variance|, min_variance)
  feature_gap       the feature planes (slope, roughness, traversability,
                    normal z) and the map's traversability plane
  store_gap         every other float leaf: the submap store (slots,
                    accumulator, staging ring, poses, centers, keyframe
                    scans), the shed rows, the motion state, map intensity
                    and center, the step's float metrics
  int_mismatch      elements of integer and bool leaves that differ
                    (counts, cursors, ids, valid masks, colors)
  intake_gap        the voxel-filtered scan as a set (m; infinite when the
                    counts differ)
  restitch_gap_m    a re-stitch's slots x, y, z, poses and centers, and
                    every other float leaf of the store (m)
  restitch_variance_gap_rel  the re-stitched slots' variance, relative

Equal values (also two infinities, or two NaNs) count as no gap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import (features as r_features, fuse_stream as
                                 r_fuse_stream, move as r_move,
                                 pipeline as r_pipeline, submaps as r_submaps,
                                 updater as r_updater, state as r_state)

# the reference's dataclasses by name: a program tree converts field by field
_REFERENCE_TYPES = {c.__name__: c for c in (
    r_pipeline.PipelineState, r_pipeline.Frame, r_pipeline.StepOutputs,
    r_state.MapState, r_updater.MotionState, r_submaps.SubmapStore,
    r_submaps.PointBuffer, r_features.FeatureMaps, r_move.ShedCells)}


def to_reference(tree, device):
    """A tree of the program's dataclasses (host or device leaves) as the
    reference's dataclasses, every leaf a fresh copy on `device`."""
    if dataclasses.is_dataclass(tree):
        cls = _REFERENCE_TYPES[type(tree).__name__]
        return cls(**{f.name: to_reference(getattr(tree, f.name), device)
                      for f in dataclasses.fields(cls)})
    if isinstance(tree, dict):
        return {k: to_reference(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return tree.to(device, copy=True)


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} over dataclasses and dicts (None left out); Python
    numbers become tensors."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if tree is None:
        return {}
    if not isinstance(tree, torch.Tensor):
        tree = torch.as_tensor(tree)
    return {prefix[:-1]: tree}


def _gap(a, b, scale=None):
    """Largest |a - b| (over `scale` where given), equal values no gap."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    d = torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)),
                    torch.zeros_like(a), (a - b).abs())
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    if scale is not None:
        d = d / scale
    return float(d.max()) if d.numel() else 0.0


def _frame_number(path: str) -> str:
    leaf = path.split("/", 1)[1]
    if leaf in ("map/elevation", "map/lowest"):
        return "elevation_gap_m"
    if leaf == "map/variance":
        return "variance_gap_rel"
    if leaf == "map/traver" or leaf.startswith("features/"):
        return "feature_gap"
    return "store_gap"


def _restitch_number(path: str) -> str:
    return ("restitch_variance_gap_rel" if path.endswith("slots/variance")
            else "restitch_gap_m")


def compare(reference, candidate, number_of, min_variance: float) -> dict:
    """The numbers of one check: `reference` and `candidate` are trees of
    one layout (the candidate's paths must all be the reference's)."""
    ref, got = flatten(reference), flatten(candidate)
    if set(ref) != set(got):
        raise ValueError(f"trees differ: {sorted(set(ref) ^ set(got))}")
    out = {}
    for path, r in ref.items():
        g = got[path].to(r.device)
        if r.shape != g.shape:
            raise ValueError(f"{path}: shape {tuple(g.shape)}, reference "
                             f"{tuple(r.shape)}")
        if not r.is_floating_point():
            name = "int_mismatch"
            value = float((r != g).sum())
        else:
            name = number_of(path)
            scale = None
            if name.endswith("_rel"):
                scale = torch.clamp(r.to(torch.float64).abs(),
                                    min=min_variance)
            value = _gap(r, g, scale)
        out[name] = max(out.get(name, 0.0), value)
    return out


def merge(into: dict, numbers: dict) -> dict:
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), v)
    return into


def frame_numbers(ref_state, ref_out, state, out, cfg, pools=None) -> dict:
    """With `pools` ({slot: the reference's filtered scan of the frame that
    wrote the slot}), the keyframe scans are held by `keyframe_scan_gap`
    instead of row by row."""
    tree = lambda st, o: {"state": st} if o is None else \
        {"state": st, "out": o}
    if pools is None:
        return compare(tree(ref_state, ref_out), tree(state, out),
                       _frame_number, cfg.map.min_variance)
    strip = lambda st: st.replace(submaps=st.submaps.replace(
        kf_points=st.submaps.kf_points[:0]))
    numbers = compare(tree(strip(ref_state), ref_out),
                      tree(strip(state), out), _frame_number,
                      cfg.map.min_variance)
    return merge(numbers, {"store_gap": keyframe_scan_gap(
        ref_state.submaps, state.submaps, pools)})


def written_slots(before, after) -> list:
    """The slots of the keyframe-scan ring that differ between two
    stores' `kf_points`."""
    b = before.to(after.device)
    return [k for k in range(after.shape[0]) if not torch.equal(b[k],
                                                                after[k])]


def keyframe_scan_gap(ref_store, store, pools: dict) -> float:
    """The stored keyframe scans.  A keyframe's scan subsamples its
    filtered points in the filter's output order, which is the host
    runtime's hash order in the program and the sorted cell order in the
    reference.  So a slot in `pools` is held by membership (each stored
    row's distance to the nearest point of the reference's filtered scan,
    the rows past the count zero) and every other slot row by row."""
    ref = ref_store.kf_points
    got = store.kf_points.to(ref.device)
    counts = store.kf_counts.to(ref.device)
    gap = 0.0
    for slot in range(ref.shape[0]):
        if slot not in pools:
            gap = max(gap, _gap(ref[slot], got[slot]))
            continue
        pool = pools[slot].to(ref.device, torch.float64)
        rows = got[slot, :int(counts[slot])].to(torch.float64)
        for lo in range(0, rows.shape[0], 1024):
            d = torch.cdist(rows[lo:lo + 1024], pool, p=float("inf"))
            gap = max(gap, float(d.min(dim=1).values.max()))
        tail = got[slot, int(counts[slot]):]
        gap = max(gap, _gap(torch.zeros_like(tail), tail))
    return gap


def restitch_numbers(ref_store, ref_stats, store, stats, cfg) -> dict:
    return compare({"store": ref_store, "stats": ref_stats},
                   {"store": store, "stats": stats}, _restitch_number,
                   cfg.map.min_variance)


def filtered_points(frame):
    """The valid rows of a frame's points."""
    return frame.points[frame.valid]


def intake_gap(ref_frame, frame) -> float:
    """The filtered scans as sets: the valid rows of each frame, sorted."""
    def rows(f):
        v = f.valid.cpu().numpy()
        p = f.points.cpu().numpy()[v]
        i = f.intensity.cpu().numpy()[v]
        a = np.concatenate([p, i[:, None]], 1).astype(np.float64)
        return a[np.lexsort(a.T[::-1])]
    a, b = rows(ref_frame), rows(frame)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def kernel_work(ref_state, ref_frames, rcfg, plugins: dict) -> list:
    """Per frame of `ref_frames`, run from `ref_state` by the reference:
    {name: what the work plug-in `name` (benchmark/work/<name>.py) counted}.
    The reference reports its stages through `PROBE(kind, *args)`; each
    plug-in's `count(kind, args, rcfg)` returns what it counts from a
    stage, or None for a stage it does not read."""
    work = []

    def probe(kind, *args):
        for name, plugin in plugins.items():
            v = plugin.count(kind, args, rcfg)
            if v is not None:
                work[-1][name] = v

    r_fuse_stream.PROBE = r_features.PROBE = probe
    try:
        for f in ref_frames:
            work.append({})
            ref_state, _ = r_pipeline.step(ref_state, f, rcfg)
    finally:
        r_fuse_stream.PROBE = r_features.PROBE = None
    return work


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number within its limit, [(name, value, limit)]).  A number
    without a limit, or a limit without a number, is not correct."""
    rows = []
    ok = True
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        limit = limits.get(name)
        good = value is not None and limit is not None and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
