"""What the benchmark imports: never jax, jaxlib, flax or the JAX package
(top-level module names compared whole, so `gem_tpu_torch` is not
`gem_tpu`), and the reference nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import REPO

BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "gem_tpu"}


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in _modules():
        if os.sep + "reference" + os.sep in path:
            assert "gem_tpu_torch" not in set(_imports(path)), path


def test_run_loads_no_jax():
    """The command's modules and every plug-in the harness finds by name,
    imported in a fresh process."""
    code = ("import os, sys, benchmark.run, benchmark.harness, "
            "benchmark.loopkit, benchmark.control, gem_tpu_torch.io.replay, "
            "gem_tpu_torch.mapping.pipeline, "
            "gem_tpu_torch.global_map.loop_closure\n"
            "from benchmark import registry\n"
            "b = registry.Benchmark('.')\n"
            "for kind in ('loops', 'feeds', 'scans', 'metrics', 'work'):\n"
            "    for f in os.listdir(os.path.join('benchmark', kind)):\n"
            "        if f.endswith('.py'):\n"
            "            b.plugin(kind, f[:-3])\n"
            "bad = {m.split('.')[0] for m in sys.modules} & set("
            f"{sorted(FORBIDDEN)!r})\n"
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stdout + p.stderr
