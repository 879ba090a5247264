"""A tiny benchmark root for the harness's CPU tests: the repository's
BENCHMARK.json, limits and plug-ins (loops, feeds, scans, metric readers,
work counts), with small configurations and traffic of the same kinds,
written into a temporary directory."""

from __future__ import annotations

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

# small sizes of the same configurations: a 128-cell map, 4096-point
# frames, a 4-slot ring of 2048 points
PIPELINE = {"map": {"length": 128, "max_shift_cells": 16},
            "max_points": 4096,
            "submap": {"max_submaps": 4, "capacity": 2048,
                       "keyframe_distance": 2.0, "overlap_radius": 6.0,
                       "staging_frames": 4, "max_pairs_per_submap": 2}}
KITTI = {"max_points": 2048, "submap": {"max_submaps": 4, "capacity": 2048,
                                        "keyframe_distance": 2.0,
                                        "keyframe_scan_points": 256,
                                        "staging_frames": 4}}
TRAFFIC = {"points": 4096, "max_range_m": 6.0, "circuit_frames": 48,
           "speed_m_per_frame": 0.5, "warmup_frames": 6, "trace_from": 1,
           "trace_frames": 3, "check_frames": 2, "check_within": 10,
           "fill_frames_max": 200, "check_events_within": 6,
           "check_events": 2, "warmup_events": 1, "preroll_s": 0.2}
RAW = {"points": 1920, "max_range_m": 20.0}
# the folders of files that the harness finds by name
PLUGINS = ("loops", "feeds", "scans", "metrics", "work")


def _update(d, u):
    for k, v in u.items():
        if isinstance(v, dict):
            _update(d[k], v)
        else:
            d[k] = v
    return d


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


def _write(root, rel, data):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)


def with_deferred(spec: dict) -> dict:
    """BENCHMARK.json with the cells kept out of it for now
    (benchmark/deferred/<cell>.json: the entries a later PR would add)."""
    folder = os.path.join(REPO, "benchmark", "deferred")
    for f in sorted(os.listdir(folder)):
        d = _read("benchmark", "deferred", f)
        spec["configs"] += d["configs"]
        spec["workloads"] += d["workloads"]
        spec["per_layer"] += d["per_layer"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            extra = {**d["end_to_end"], **d["per_layer_workloads"]}.get(
                m["name"])
            if extra and "workloads" in m:
                m["workloads"] = m["workloads"] + extra
    return spec


def make_root(root: str, limits=None) -> str:
    """Write the tiny root into `root` and return it, the deferred cells
    added."""
    spec = with_deferred(_read("BENCHMARK.json"))
    _write(root, "BENCHMARK.json", spec)
    for c in spec["configs"]:
        conf = _read(c["file"])
        _update(conf["pipeline"], copy.deepcopy(
            KITTI if c["name"] == "kitti_demo" else PIPELINE))
        _write(root, c["file"], conf)
    for w in spec["workloads"]:
        t = _read("benchmark", "traffic", w["traffic"] + ".json")
        t.update(TRAFFIC)
        if t["scan"] == "hdl64":
            t.update(RAW)
        _write(root, f"benchmark/traffic/{w['traffic']}.json", t)
        cell = _read("benchmark", "cells", w["name"] + ".json")
        if limits is not None:
            cell["limits"] = {k: limits for k in cell["limits"]}
        _write(root, f"benchmark/cells/{w['name']}.json", cell)
    for kind in PLUGINS:
        shutil.copytree(os.path.join(REPO, "benchmark", kind),
                        os.path.join(root, "benchmark", kind),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return root
