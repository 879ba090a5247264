"""The metrics that read the program's own tracer (benchmark/porttrace.py),
from traced runs of each cell at a tiny size on the CPU: every one is
reported in its cell while the tracer itself stays off (no stamp, no
ring), and none against a program that has no tracer (an older commit),
whose traced run still completes."""

import sys
import types

import pytest

from benchmark import harness, porttrace, registry
from benchmark.tests.tiny import REPO

SEED = 2 ** 31 + 23
NEW = {
    "hdl64_100m.online": ["copy_in_ms.frame", "replay_ms.frame",
                          "copy_out_ms.frame"],
    "hdl64_100m.restitch": ["restitch_host_ms.restitch",
                            "restitch_read_ms.restitch",
                            "restitch_reads.restitch"],
}


@pytest.fixture
def tracer_restored():
    t = porttrace.tracer()
    yield t
    t.enable(False)
    t.reset()


def test_every_new_metric_is_declared_for_its_cell():
    bench = registry.Benchmark(REPO)
    for cell, names in NEW.items():
        declared = {m["name"] for m in bench.cell(cell).per_layer}
        assert set(names) <= declared, cell


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reports_the_tracer_metrics(tiny_root, cell,
                                               tracer_restored):
    out = harness.run_cell(tiny_root, cell, SEED, 3.0, True, "cpu")
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in NEW[cell]:
        assert name in got and got[name]["value"] >= 0, (name, got)
    # the profiler alone turned the spans on: nothing was stamped
    assert not tracer_restored.on and tracer_restored._rings == {}
    if cell == "hdl64_100m.restitch":
        # slot_corrections reads ids, count and poses; then the centers and
        # the fused-cell count
        assert got["restitch_reads.restitch"]["value"] == 5


@pytest.mark.parametrize("cell", sorted(NEW))
def test_no_tracer_reports_nothing(tiny_root, cell, tracer_restored,
                                   monkeypatch):
    """The readers see the module an older program has: `trace` and
    `MetricsLogger`, no tracer."""
    import gem_tpu_torch.utils as utils

    older = types.ModuleType("gem_tpu_torch.utils.observability")
    older.trace, older.MetricsLogger = object(), object()
    monkeypatch.setattr(utils, "observability", older)
    monkeypatch.setitem(sys.modules, older.__name__, older)
    out = harness.run_cell(tiny_root, cell, SEED, 2.0, True, "cpu")
    assert out["correct"], out["checks"]
    assert not set(NEW[cell]) & set(out["metrics"])
    assert out["metrics"], "the older metrics are still reported"
