"""The copied byte and operation arithmetic gives chip_smoke.py's numbers
on fixed shapes."""

import sys

import pytest
import torch

from benchmark import yardstick
from benchmark.tests.tiny import REPO

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _offsets(L, counts):
    c = torch.tensor(counts, dtype=torch.int64)
    return torch.cat([torch.zeros(1, dtype=torch.int64), c.cumsum(0)])


@pytest.mark.parametrize("L,counts", [
    (4, [0, 3, 0, 1, 5, 0, 0, 2, 0, 0, 0, 0, 1, 0, 0, 7]),
    (1000, [0] * 999_000 + [2] * 1000),
])
def test_k1_bound_is_chip_smokes(L, counts):
    off = _offsets(L, counts)
    P = int(off[-1]) + 16
    h = torch.zeros(P)
    args = (off, h, h, h, h, torch.zeros(L * L), torch.zeros(L * L), None)
    assert yardstick.k1_bound(*yardstick.k1_counts(off)) \
        == chip_smoke.k1_bound(args)


@pytest.mark.parametrize("cells,fitted", [(1_000_000, 0),
                                          (1_000_000, 400_000),
                                          (5625, 5625)])
def test_k2_bound_is_phase_4s(cells, fitted):
    want = chip_smoke.bound(24 * cells, chip_smoke.K2_OPS_FITTED * fitted
                            + chip_smoke.K2_OPS_COUNT * (cells - fitted))
    assert yardstick.k2_bound(cells, fitted) == want


def test_peaks_are_chip_smokes():
    assert yardstick.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert yardstick.FP32_OPS_PER_S == chip_smoke.FP32_OPS_PER_S
    assert yardstick.K1_SYMBOL == \
        chip_smoke.KERNEL_SYMBOLS["fuse_stream_aggregate"]
    assert yardstick.K2_SYMBOL == chip_smoke.KERNEL_SYMBOLS[
        "plane_fit_features"]
