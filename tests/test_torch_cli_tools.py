"""`python -m gem_tpu_torch` (gem_tpu_torch/io/cli.py) on the CPU, besides
`run` and `fleet`: `selftest` and `viz` work, `--device cuda` without a
card is an error, a checkpoint written by either CLI resumes in the other,
and the CLI process imports no jax, the global-map paths included.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gem_tpu.io import cli as jcli

from gem_tpu_torch.io import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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

