"""`python -m gem_tpu_torch fleet` (gem_tpu_torch/io/cli.py) on the CPU
against `python -m gem_tpu fleet`: one process, inter-robot loop detection,
`--coordinator` over two gloo processes, and `--mesh` in one process and
over two spawned gloo ranks; `--device cuda` without a card is an error.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from gem_tpu.io import cli as jcli

from gem_tpu_torch.io import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


MESH_JOIN_TIMEOUT_S = 300


def _mesh_ranks(tmp_path, capfd, argv, world=2):
    """`fleet --mesh` as it runs on a host with `world` cards: `world`
    spawned ranks of `_fleet_rank(..., "mesh")` joined over a FileStore,
    here gloo on the CPU.  Returns what they printed."""
    import torch.multiprocessing as mp

    args = tcli._parser().parse_args(["fleet", "--device", "cpu", "--mesh",
                                      *argv])
    capfd.readouterr()
    ctx = mp.start_processes(tcli._fleet_rank,
                             args=(args, str(tmp_path / "store"), world,
                                   "mesh"),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"mesh ranks still running after "
                                     f"{MESH_JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return capfd.readouterr().out


def test_fleet_mesh_two_ranks_drift_only_robot_zero(tmp_path, capfd):
    """Two mesh ranks of two robots each: only robot 0 of the whole fleet
    keeps its pose under --drift-yaw (not each rank's first robot), so the
    fused cells are those of `python -m gem_tpu fleet --mesh`, printed once,
    by rank 0."""
    common = ["--robots", "4", "--frames", "2", "--drift-yaw", "8"]
    assert jcli.main(["fleet", "--mesh", "--platform", "cpu", *common]) == 0
    j = _fleet_lines(capfd.readouterr().out)
    out = _mesh_ranks(tmp_path, capfd, ["--fuse-backend", "segment",
                                        *common])
    assert out.count("fleet of 4 robots") == 1
    t = _fleet_lines(out)
    assert t[0].endswith("mesh)") and j[0].endswith("mesh)")
    assert t[1] == j[1] and len(t[1]) == 4
    assert t[2] == j[2]


def test_fleet_mesh_two_ranks_loop_detect_matches_the_jax_cli(tmp_path,
                                                              capfd):
    """The loop-detect command over two mesh ranks, one robot each: rank 0
    gathers both submap stores in robot order and prints JAX's per-robot
    fused cells, loops and pairs (as sets), and the InterPR records."""
    cmd = ["--robots", "2", "--frames", "25", "--world-seed", "3",
           "--drift-yaw", "8", "--drift-x", "1.0", "--loop-detect"]
    assert jcli.main(["fleet", "--mesh", "--platform", "cpu", *cmd]) == 0
    j = _fleet_lines(capfd.readouterr().out)
    out = _mesh_ranks(tmp_path, capfd, [
        "--fuse-backend", "segment", *cmd, "--publish-interpr",
        str(tmp_path / "t.npz")])
    t = _fleet_lines(out)
    assert "skipped" not in out and out.count("loop-detect:") == 1
    assert t[1] == j[1]
    assert t[3]["n_loops"] == j[3]["n_loops"] >= 1
    assert sorted(map(tuple, t[3]["pairs"])) \
        == sorted(map(tuple, j[3]["pairs"]))
    assert f"{t[3]['n_loops']} InterPR records" in out
    # the one-process fleet gives the same loops from the same robots
    assert tcli.main(["fleet", "--device", "cpu", "--fuse-backend",
                      "segment", *cmd]) == 0
    one = _fleet_lines(capfd.readouterr().out)
    assert one[1] == t[1] and one[3] == t[3]


@pytest.mark.parametrize("flags", [[], ["--mesh"],
                                   ["--coordinator", "x/store"]])
def test_fleet_device_cuda_without_a_card_is_an_error(flags):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["fleet", "--device", "cuda", "--frames", "1", *flags])
