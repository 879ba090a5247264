"""K1 serves every pass-A variant of gem_tpu's streaming fuse.

`fuse_stream._kernel` (GEM_FUSE_PASSA=dot and gather) and `_kernel_scan`
(scan and scanp) compute the same 16 aggregate rows as `_kernel_fact`, the
kernel K1 replaces.  Here the port's `fuse_stream` (the plain K1 on the
CPU) is held against JAX `fuse_stream(..., interpret=True)` with
`fuse_stream._PASSA` monkeypatched to each variant, as
tests/test_fuse_stream.py does: colored and colorless batches over an
occupied prior, and one cell whose run crosses many chunk boundaries.

Tolerances: elevation, variance and intensity 5e-6 (f32 sums of a cell's
run taken in another order than the interpret-mode one-hot dots), 5e-5 for
the one-cell run of ~3900 terms; color exactly; lowest 1e-6.
"""

import numpy as np
import pytest

import gem_tpu.kernels.fuse_stream as jfs
from gem_tpu.config import benchmark_config

from test_torch_fuse_stream import (_batches, _compare, _random_batches,
                                    _run_both, _states)

CASES = {
    # name: (L, P, prior occupancy, one_cell, colored)
    "colored": (40, 2048, 0.5, False, True),
    "colorless": (40, 2048, 0.8, False, False),
    "one_cell_across_chunks": (32, 4096, 0.5, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("passa", ["dot", "gather", "scan", "scanp"])
def test_port_matches_passa_variant(monkeypatch, passa, case):
    monkeypatch.setattr(jfs, "_PASSA", passa)
    L, P, occ, one_cell, colored = CASES[case]
    rng = np.random.default_rng(len(case) + 7 * len(passa))
    cfg = benchmark_config(length=L, max_points=P)
    js, ts = _states(rng, cfg.map, occ)
    jb, tb = _random_batches(rng, L, P, 0.95,
                             one_cell=L * L // 2 if one_cell else None)
    if not colored:
        n = P
        jb, tb = _batches(L, tb.height.numpy(), tb.variance.numpy(),
                          tb.cell.numpy(), tb.valid.numpy(),
                          np.zeros(n, np.int32), np.zeros(n, np.float32))
    # the variants' chunk is 512 points below 1M: one cell of ~3900 points
    # spans eight chunks
    assert jfs._pick_chunk(P) < P
    a, b = _run_both(cfg, js, ts, jb, tb, with_color=colored)
    _compare(a, b, atol=5e-5 if one_cell else 5e-6)
    if colored:
        np.testing.assert_array_equal(b.intensity.numpy(),
                                      np.asarray(a.intensity))
