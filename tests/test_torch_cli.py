"""`python -m gem_tpu_torch` (gem_tpu_torch/io/cli.py) on the CPU: the kitti
preset writes every product, a checkpoint resumes, the global-map flags
(--dense, --save-octomap, --keyframes, --loop-demo) run and agree with
`python -m gem_tpu run --platform cpu`, a checkpoint written by either CLI
resumes in the other, `selftest` and `viz` work, and the CLI process imports
no jax.
"""

import importlib.util
import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from gem_tpu.io import cli as jcli

from gem_tpu_torch.io import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_selftest_on_the_cpu(capsys):
    assert tcli.main(["selftest", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["healthy"] and rep["fuse_backend"] == "stream"
    assert rep["fused_cells"] > 100 and rep["rmse_vs_cpu_m"] < 0.05


def test_viz_renders_a_pcd_and_needs_matplotlib(tmp_path, monkeypatch,
                                                capsys):
    assert tcli.main(["run", "--device", "cpu", "--frames", "2",
                      "--save-map", str(tmp_path / "m.pcd")]) == 0
    png = str(tmp_path / "v.png")
    if importlib.util.find_spec("matplotlib") is not None:
        assert tcli.main(["viz", str(tmp_path / "m.pcd"), "--out", png]) == 0
        assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        tcli.main(["viz", str(tmp_path / "m.pcd"), "--out", png])


def test_device_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["run", "--device", "cuda", "--frames", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["selftest", "--device", "cuda"])


def test_checkpoints_cross_between_the_two_clis(tmp_path, capsys):
    j1, t1, j2 = (str(tmp_path / n) for n in ("j1.npz", "t1.npz", "j2.npz"))
    common = ["--preset", "kitti", "--max-points", "4096", "--speed", "1.0",
              "--fuse-backend", "segment"]
    assert jcli.main(["run", "--platform", "cpu", "--frames", "3",
                      "--checkpoint", j1, *common]) == 0
    assert tcli.main(["run", "--device", "cpu", "--frames", "3",
                      "--resume", j1, "--checkpoint", t1, *common]) == 0
    assert jcli.main(["run", "--platform", "cpu", "--frames", "2",
                      "--resume", t1, "--checkpoint", j2, *common]) == 0
    out = capsys.readouterr().out
    assert "(frame 3)" in out and "(frame 6)" in out
    assert int(np.load(j2)["frame_idx"]) == 8
    assert set(np.load(j2).files) == set(np.load(t1).files)


def test_cli_process_imports_no_jax(tmp_path):
    code = ("import sys; from gem_tpu_torch.io.cli import main;"
            f" main(['run', '--device', 'cpu', '--frames', '2',"
            f" '--save-map', {str(tmp_path / 'm.pcd')!r}]);"
            " assert 'jax' not in sys.modules, 'jax imported';"
            " assert 'gem_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_global_map_paths_import_no_jax(tmp_path):
    """The loop closure, octomap and densify paths use the port's own
    copies of msgs, octomap_io and pcd, never gem_tpu.*."""
    d = str(tmp_path)
    code = ("import sys; from gem_tpu_torch.io.cli import main;"
            f" main(['run', '--device', 'cpu', '--frames', '24',"
            f" '--speed', '1.0', '--loop-demo', '--dense',"
            f" '--save-submaps', {d + '/s'!r},"
            f" '--save-octomap', {d + '/o.ot'!r}]);"
            " assert 'jax' not in sys.modules, 'jax imported';"
            " assert 'gem_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "loop closure:" in out.stdout
    assert os.path.getsize(os.path.join(d, "o_road.ot")) > 100


def _fleet_lines(out):
    """(header line, fused cells, valid points, loop-detect stats or None)
    of a `fleet` run's output."""
    head = next(x for x in out.splitlines() if x.startswith("fleet of "))
    fused = json.loads(out.split("per-robot fused cells: ")[1].splitlines()[0])
    pv = json.loads(out.split("per-robot last-frame valid points: ")[1]
                    .splitlines()[0])
    loop = None
    if "loop-detect: {" in out:
        loop = json.loads(out.split("loop-detect: ")[1].splitlines()[0])
    return head, fused, pv, loop


def test_fleet_matches_the_jax_cli(capsys):
    """`fleet` in one process on the CPU: JAX's lines, and per robot the
    fused cells and valid points of `python -m gem_tpu fleet --platform
    cpu` (the JAX fleet steps with the segment backend)."""
    common = ["--robots", "4", "--frames", "3"]
    assert jcli.main(["fleet", "--platform", "cpu", *common]) == 0
    j = _fleet_lines(capsys.readouterr().out)
    assert tcli.main(["fleet", "--device", "cpu", "--fuse-backend",
                      "segment", *common]) == 0
    t = _fleet_lines(capsys.readouterr().out)
    assert t[0].startswith("fleet of 4 robots: 3 frames")
    assert t[0].endswith("fleet-Hz, vmap)") and j[0].endswith("vmap)")
    assert t[1] == j[1] and len(t[1]) == 4 and min(t[1]) > 1000
    assert t[2] == j[2]


def test_fleet_loop_detect_matches_the_jax_cli(tmp_path, capsys):
    """The README's loop-detect command in both packages: the same loops
    and pairs (compared as sets: loops come strongest first), and InterPR
    records naming the same submaps."""
    from gem_tpu_torch import msgs

    cmd = ["fleet", "--robots", "2", "--frames", "80", "--world-seed", "3",
           "--drift-yaw", "8", "--drift-x", "1.0", "--loop-detect",
           "--publish-interpr"]
    assert jcli.main([*cmd, str(tmp_path / "j.npz"), "--platform",
                      "cpu"]) == 0
    j = _fleet_lines(capsys.readouterr().out)
    assert tcli.main([*cmd, str(tmp_path / "t.npz"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    t = _fleet_lines(out)
    assert t[3]["n_loops"] == j[3]["n_loops"] >= 1
    assert sorted(map(tuple, t[3]["pairs"])) \
        == sorted(map(tuple, j[3]["pairs"]))
    assert f"{t[3]['n_loops']} InterPR records" in out
    rt = msgs.InterPRsRecord.load(str(tmp_path / "t.npz"))
    rj = msgs.InterPRsRecord.load(str(tmp_path / "j.npz"))
    assert sorted((x.id0, x.id1) for x in rt.items) \
        == sorted((x.id0, x.id1) for x in rj.items)


def test_fleet_coordinator_two_gloo_processes(tmp_path, capsys):
    """`fleet --coordinator` in two processes joined over a FileStore
    (gloo on the CPU): each prints JAX's lines for its own two robots, and
    together they fuse what the one-process fleet fuses."""
    store = str(tmp_path / "store")
    argv = lambda i: [sys.executable, "-m", "gem_tpu_torch", "fleet",
                      "--device", "cpu", "--robots", "4", "--frames", "2",
                      "--max-points", "128", "--coordinator", store,
                      "--num-processes", "2", "--process-id", str(i)]
    procs = [subprocess.Popen(argv(i), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, out + err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    fused = []
    for i, out in enumerate(outs):
        assert f"process {i}/2: gloo on cpu" in out
        head, f, pv, _ = _fleet_lines(out)
        assert head.startswith("fleet of 4 robots") \
            and head.endswith("distributed)")
        assert len(f) == len(pv) == 2
        fused += f
    assert tcli.main(["fleet", "--device", "cpu", "--robots", "4",
                      "--frames", "2", "--max-points", "128"]) == 0
    assert _fleet_lines(capsys.readouterr().out)[1] == fused


def test_fleet_mesh_on_the_cpu_is_one_process(capsys):
    """`--mesh` spawns one process per visible card; on the CPU that is
    this process, over a process group of one."""
    assert tcli.main(["fleet", "--device", "cpu", "--mesh", "--robots", "2",
                      "--frames", "2", "--max-points", "256"]) == 0
    head, fused, pv, _ = _fleet_lines(capsys.readouterr().out)
    assert head.endswith("mesh)") and len(fused) == 2
    import torch.distributed as dist

    assert not dist.is_initialized()        # the group was left


@pytest.mark.parametrize("flags", [[], ["--mesh"],
                                   ["--coordinator", "x/store"]])
def test_fleet_device_cuda_without_a_card_is_an_error(flags):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["fleet", "--device", "cuda", "--frames", "1", *flags])
