"""`python -m gem_tpu_torch run` (gem_tpu_torch/io/cli.py) on the CPU: the
kitti preset writes every product, and the global-map flags (--dense,
--save-octomap, --keyframes, --loop-demo) run and agree with `python -m
gem_tpu run --platform cpu`.  The other subcommands' tests are
tests/test_torch_cli_tools.py (selftest, viz, checkpoints, no jax) and
tests/test_torch_cli_fleet.py (fleet), one file each so that test workers
share them out.
"""

import json
import os
import re
import struct

import numpy as np
import pytest

from gem_tpu.io import cli as jcli

from gem_tpu_torch.io import cli as tcli


def _png_shape(path):
    with open(path, "rb") as f:
        head = f.read(26)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    w, h, depth, ctype = struct.unpack(">IIBB", head[16:26])
    assert depth == 8 and ctype == 2          # 8-bit RGB
    return h, w, 3


def _pcd_points(path):
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"POINTS"):
                return int(line.split()[1])
    raise AssertionError(f"{path}: no POINTS line")



def test_run_kitti_writes_every_product(tmp_path, capsys):
    d = str(tmp_path)
    p = lambda name: os.path.join(d, name)
    argv = ["run", "--device", "cpu", "--preset", "kitti", "--frames", "12",
            "--speed", "1.0", "--fuse-backend", "pallas",
            "--save-map", p("map.pcd"), "--save-ortho", p("ortho.png"),
            "--save-heatmap", p("heat.png"), "--save-costmap", p("cost.png"),
            "--checkpoint", p("ck.npz"), "--metrics-out", p("m.jsonl"),
            "--publish-submaps", p("records"), "--save-submaps", p("subs"),
            "--log-every", "6"]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "processed 12 frames" in out and "submaps=1" in out
    L = 75
    for name in ("ortho.png", "heat.png", "cost.png"):
        assert _png_shape(p(name)) == (L, L, 3), name
    assert _pcd_points(p("map.pcd")) > 1000
    assert _pcd_points(p("subs/0.pcd")) > 100
    rows = [json.loads(x) for x in open(p("m.jsonl"))]
    assert [r["frame"] for r in rows] == list(range(1, 13))
    assert all(r["points_valid"] > 0 for r in rows)
    rec = np.load(p("records/submap_0.npz"))
    assert rec["ortho_image"].shape == (L, L, 3)
    assert rec["ortho_image"].dtype == np.uint8
    assert rec["points"].shape[0] > 100
    assert rec["keyframe_points"].shape[1] == 3
    ck = np.load(p("ck.npz"))
    assert int(ck["frame_idx"]) == 12 and ck["submaps/orthos"].shape[1] == L

    assert tcli.main(["run", "--device", "cpu", "--frames", "2",
                      "--resume", p("ck.npz"), "--scan", "2",
                      "--checkpoint", p("ck2.npz")]) == 0
    assert "(frame 12)" in capsys.readouterr().out
    assert int(np.load(p("ck2.npz"))["frame_idx"]) == 14


def _keyframes(path, n):
    """A KeyframesRecord of n optimised poses: keyframe k shifted by
    (0.2 k, -0.1 k) m."""
    from gem_tpu.msgs import KeyframesRecord

    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = 0.2 * np.arange(n)
    poses[:, 1] = -0.1 * np.arange(n)
    poses[:, 3] = 1.0
    KeyframesRecord(ids=np.arange(n, dtype=np.int32), poses=poses).save(path)
    return path


@pytest.mark.parametrize("flags", [["--dense"], ["--save-octomap", "o.npz"],
                                   ["--keyframes", "k.npz"],
                                   ["--loop-demo"]])
def test_global_map_flags_run_on_the_cpu(flags, tmp_path, capsys):
    """Each flag of the global-map slice runs on the CPU: densified submap
    PCDs, the pyramid npz, and the loop-closure re-stitch from a record or
    the demo drift."""
    flags = [str(tmp_path / f) if f.endswith(".npz") else f for f in flags]
    if "--keyframes" in flags:
        _keyframes(flags[1], 3)
    subs = str(tmp_path / "subs")
    assert tcli.main(["run", "--device", "cpu", "--frames", "24", "--speed",
                      "1.0", "--save-submaps", subs, "--save-map",
                      str(tmp_path / "map.pcd"), *flags]) == 0
    out = capsys.readouterr().out
    assert "submaps=2" in out
    if "--dense" in flags:
        assert "2 submaps (densified)" in out
        assert _pcd_points(os.path.join(subs, "0.pcd")) > 5000
    if "--save-octomap" in flags:
        d = np.load(flags[1])
        assert d["road_l0_occ"].shape[2] == 128 and d["road_l0_occ"].any()
        assert d["obstacle_l2_occ"].shape == (d["road_l0_occ"].shape[0] // 4,
                                              d["road_l0_occ"].shape[1] // 4,
                                              32)
    if "--keyframes" in flags or "--loop-demo" in flags:
        stats = json.loads(out.split("loop closure: ")[1].splitlines()[0])
        assert stats["n_corrected"] == 2 and stats["n_pairs"] == 2
        assert stats["n_cells_fused"] > 1000
        assert _pcd_points(str(tmp_path / "map.pcd.before_loop.pcd")) > 1000


def _loop_stats_and_voxels(out):
    stats = json.loads(out.split("loop closure: ")[1].splitlines()[0])
    road, obs = re.search(r"road (\d+) / obstacle (\d+) voxels", out).groups()
    return stats, int(road), int(obs)


def test_loop_demo_octomap_agrees_with_the_jax_cli(tmp_path, capsys):
    """`run --loop-demo --save-octomap o.bt` in both packages: the same pair
    list and round schedule, road/obstacle voxel counts within 1%.  The yq
    preset over 24 frames closes two submaps, so the demo drift moves them
    by whole cells and no cell key sits on a ceil boundary."""
    common = ["--preset", "yq", "--frames", "24", "--speed", "1.0",
              "--fuse-backend", "segment", "--loop-demo"]
    assert jcli.main(["run", "--platform", "cpu", *common, "--save-octomap",
                      str(tmp_path / "j.bt")]) == 0
    j = _loop_stats_and_voxels(capsys.readouterr().out)
    assert tcli.main(["run", "--device", "cpu", *common, "--save-octomap",
                      str(tmp_path / "t.bt")]) == 0
    t = _loop_stats_and_voxels(capsys.readouterr().out)
    assert t[0]["n_pairs"] == j[0]["n_pairs"] > 0
    assert t[0]["n_rounds"] == j[0]["n_rounds"]
    for a, b in zip(t[1:], j[1:]):
        assert abs(a - b) <= 0.01 * b, (t, j)
    for name in ("road", "obstacle"):
        assert os.path.getsize(tmp_path / f"t_{name}.bt") > 100

