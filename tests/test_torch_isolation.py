"""The port is self-contained: nothing of it imports or opens anything under
gem_tpu/, and no run of it writes there.

One subprocess installs an import hook that refuses `gem_tpu`, `gem_tpu.*`
and `jax`, and an audit hook that refuses any open, mkdir, rename or remove
of a path under gem_tpu/.  It then imports every module of gem_tpu_torch
and chip_smoke.py, converts a seeded KITTI-layout drive with the port's
converter, and runs `python -m gem_tpu_torch run` on the CPU at the kitti
preset over those frames (the native prefetcher, voxel filter and cell
dedup) with an .ot octomap and a PCD map, and `fleet` (2 robots, loop
detection) on the CPU.  The native library must be the port's own, built
under build/gem_tpu_torch/.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r'''
import importlib.abc, os, pkgutil, runpy, sys
import numpy as np

REPO, WORK = sys.argv[1], sys.argv[2]
GEM = os.path.join(REPO, "gem_tpu") + os.sep


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("gem_tpu", "jax", "jaxlib"):
            raise ImportError(f"refused: import {name}")
        return None


def audit(event, args):
    if event in ("open", "os.mkdir", "os.rename", "os.remove", "os.rmdir"):
        p = args[0]
        if isinstance(p, (str, bytes, os.PathLike)):
            p = os.path.abspath(os.fsdecode(p))
            if p.startswith(GEM) or p == GEM[:-1]:
                raise PermissionError(f"refused: {event} {p}")


sys.meta_path.insert(0, Refuse())
sys.addaudithook(audit)
sys.path.insert(0, REPO)

import gem_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gem_tpu_torch.__path__,
                                               "gem_tpu_torch.")]
for name in names:
    if name != "gem_tpu_torch.__main__":   # runs the CLI when imported
        __import__(name)
import chip_smoke

from gem_tpu_torch.io import kitti
rng = np.random.default_rng(0)
drive = os.path.join(WORK, "drive")
for sub in ("velodyne_points", "oxts"):
    os.makedirs(os.path.join(drive, sub, "data"))
for i in range(4):
    n = 6000
    scan = np.stack([rng.uniform(-7, 7, n), rng.uniform(-7, 7, n),
                     -1.2 + 0.02 * rng.normal(size=n),
                     rng.random(n)], 1).astype(np.float32)
    scan.tofile(os.path.join(drive, "velodyne_points", "data",
                             f"{i:010d}.bin"))
    row = [49.0, 8.4 + 3e-6 * i, 110.0, 0.0, 0.0, 0.0] + [0.0] * 24
    with open(os.path.join(drive, "oxts", "data", f"{i:010d}.txt"),
              "w") as f:
        f.write(" ".join(f"{v:.9f}" for v in row))
frames = os.path.join(WORK, "frames")
assert kitti.convert_drive(drive, frames) == 4

sys.argv = ["gem_tpu_torch", "run", "--device", "cpu", "--preset", "kitti",
            "--dataset", frames, "--frames", "4",
            "--save-octomap", os.path.join(WORK, "x.ot"),
            "--save-map", os.path.join(WORK, "map.pcd")]
try:
    runpy.run_module("gem_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, f"run exited {e.code}"

sys.argv = ["gem_tpu_torch", "fleet", "--device", "cpu", "--robots", "2",
            "--frames", "3", "--max-points", "512", "--loop-detect"]
try:
    runpy.run_module("gem_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, f"fleet exited {e.code}"

from gem_tpu_torch import native
assert native._lib is not None, "the native library was not loaded"
path = native.library_path()
assert os.path.dirname(path) == os.path.join(REPO, "build", "gem_tpu_torch")
assert os.path.exists(path)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("gem_tpu", "jax", "jaxlib"))
assert not bad, bad
print("modules", len(names))
print("ok")
'''


def test_port_reads_and_writes_nothing_under_gem_tpu(tmp_path):
    before = sorted(os.listdir(os.path.join(REPO, "gem_tpu", "native")))
    out = subprocess.run([sys.executable, "-c", _CHILD, REPO, str(tmp_path)],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert int(next(x for x in lines if x.startswith("modules")).split()[1]) \
        > 30
    assert "processed 4 frames" in out.stdout
    assert "fleet of 2 robots: 3 frames" in out.stdout
    assert "loop-detect: {" in out.stdout
    assert os.path.getsize(tmp_path / "x_road.ot") > 100
    assert os.path.getsize(tmp_path / "map.pcd") > 1000
    assert sorted(os.listdir(os.path.join(REPO, "gem_tpu", "native"))) \
        == before
