"""`restitch_joins.restitch`: the K4 launches per profiled event, read from
the program's counter `restitch.joins`; nothing where the program never
counted one (the plain join on the CPU, or a program without K4)."""

import types

import pytest

from benchmark import porttrace, registry
from benchmark.tests.tiny import REPO


@pytest.fixture
def log(monkeypatch):
    t = porttrace.tracer()
    monkeypatch.setattr(t, "log", [])
    return t.log


def _event(log, unit, joins):
    log.append(("span", porttrace.EVENT, unit, 0, 1))
    for n in joins:
        log.append(("count", "restitch.joins", unit, n))


def test_joins_per_event(log):
    read = registry.Benchmark(REPO).reader("restitch_joins.restitch").read
    for unit, joins in enumerate(([1] * 9, [1] * 5, [1] * 7)):
        _event(log, unit, joins)
    assert read(types.SimpleNamespace(units=2)) == 6.0
    assert read(types.SimpleNamespace(units=0)) is None


def test_no_counter_reads_nothing(log):
    read = registry.Benchmark(REPO).reader("restitch_joins.restitch").read
    for unit in range(3):
        _event(log, unit, [])
        log.append(("count", "restitch.reads", unit, 5))
    assert read(types.SimpleNamespace(units=3)) is None
