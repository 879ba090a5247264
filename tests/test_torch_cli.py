"""`python -m gem_tpu_torch run` (gem_tpu_torch/io/cli.py) on the CPU: the
kitti preset writes every ported product, a checkpoint resumes, the
unported flags fail before the first frame, and a checkpoint written by
`python -m gem_tpu run --platform cpu` resumes in the port and the reverse.
"""

import json
import os
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


@pytest.mark.parametrize("flags", [["--dense"], ["--save-octomap", "o.npz"],
                                   ["--keyframes", "k.npz"],
                                   ["--loop-demo"]])
def test_unported_flags_fail_before_the_first_frame(flags, capsys):
    with pytest.raises(SystemExit, match="ROADMAP"):
        tcli.main(["run", "--device", "cpu", "--frames", "1", *flags])
    assert "processed" not in capsys.readouterr().out


def test_device_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["run", "--device", "cuda", "--frames", "1"])


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
