"""The port's plane-fit features (gem_tpu_torch/kernels/features.py, the
module of kernel K2) against gem_tpu's Pallas stencil in interpret mode and
its XLA version.

Moments are formed op for op like the reference, so neighbour counts and
roughness agree bitwise.  normal_z/slope/traver differ in the last bits for
three reasons, none of them a fault of the port (the two tests at the end
show each): XLA's CPU code generator contracts `c + a * b` into one FMA
inside a jitted fusion (the Sxz/Syz/Szz moment sums, p2, detb, the
eigenvalue), where PyTorch rounds the product first; XLA's acos and
PyTorch's differ by up to 2 ULP on the same input, and their cos by up to
1 ULP (the Pallas kernel uses yet another, polynomial acos,
kernels/mathx.py).  The normal is the eigenvector of the smallest
eigenvalue, which moves by ~eps * lambda_max / gap for an eigenvalue gap
`gap`, so the bound per cell is
max(1e-5, 8e-6 / (gap / lambda_max)) on normal_z (~130 ULP
of lambda_max) — the JAX suite's 1e-5
wherever the fit is well conditioned — divided by sqrt(1 - normal_z^2) for
slope and traver (d acos/dx), and at least 1e-3 where
normal_z > 1 - 1e-6, where one ULP of normal_z is ~3e-4 rad.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_tpu.config import MapConfig
from gem_tpu.core.state import init_map_state
from gem_tpu.kernels.features import compute_features as jcompute
from gem_tpu.kernels.features_pallas import compute_features_pallas

from gem_tpu_torch.core.state import MapState
from gem_tpu_torch.kernels import features as tft


def _states(cfg, elev, start):
    js = init_map_state(cfg).replace(elevation=jnp.asarray(elev),
                                     start=jnp.asarray(start, jnp.int32))
    ts = MapState(**{f.name: torch.from_numpy(np.array(getattr(js, f.name)))
                     for f in dataclasses.fields(MapState)})
    return js, ts


def _terrain(rng, cfg, kind):
    L = cfg.length
    if kind == "random":
        elev = rng.normal(size=(L, L))
    else:   # smooth slopes and flat patches: normal_z near 1 everywhere
        g = np.arange(L) * cfg.resolution
        elev = 0.3 * np.sin(g[:, None] / 2.0) + 0.1 * g[None, :]
        elev[: L // 3, : L // 3] = 0.25
    elev = elev.astype(np.float32)
    elev[rng.random((L, L)) < 0.3] = cfg.invalid_elevation
    return elev


def _relative_gap(elev, start, cfg):
    """Per cell (lambda_1 - lambda_0) / |lambda_2| of the 5x5 plane-fit
    scatter matrix, in float64 NumPy (independent of both packages)."""
    L, res, inv = cfg.length, cfg.resolution, cfg.invalid_elevation
    geo_r = (np.arange(L) - start[0]) % L
    geo_c = (np.arange(L) - start[1]) % L
    S = {k: np.zeros((L, L)) for k in ("n", "x", "y", "z", "xx", "yy", "xy",
                                       "xz", "yz", "zz")}
    for i in range(-2, 3):
        for j in range(-2, 3):
            z = np.roll(elev, (-i, -j), (0, 1)).astype(np.float64)
            m = (((geo_r + i >= 0) & (geo_r + i < L))[:, None]
                 & ((geo_c + j >= 0) & (geo_c + j < L))[None, :]
                 & (z != inv)).astype(np.float64)
            x, y = i * res, j * res
            for k, t in (("n", 1), ("x", x), ("y", y), ("z", z),
                         ("xx", x * x), ("yy", y * y), ("xy", x * y),
                         ("xz", x * z), ("yz", y * z), ("zz", z * z)):
                S[k] += m * t
    n = np.maximum(S["n"], 1.0)
    c = lambda a, b: S[a + b] - S[a] * S[b] / n
    M = np.stack([np.stack([c("x", "x"), c("x", "y"), c("x", "z")], -1),
                  np.stack([c("x", "y"), c("y", "y"), c("y", "z")], -1),
                  np.stack([c("x", "z"), c("y", "z"), c("z", "z")], -1)], -2)
    ev = np.linalg.eigvalsh(M)
    return (ev[..., 1] - ev[..., 0]) / np.maximum(np.abs(ev[..., 2]), 1e-30)


def _check(got, want, elev, start, cfg):
    np.testing.assert_array_equal(got.neighbor_count.numpy(),
                                  np.asarray(want.neighbor_count))
    np.testing.assert_array_equal(got.rough.numpy(), np.asarray(want.rough))
    nz = np.asarray(want.normal_z).astype(np.float64)
    tol_nz = np.maximum(1e-5, 8e-6 / np.maximum(
        _relative_gap(elev, start, cfg), 1e-30))
    tol = {"normal_z": tol_nz,
           "slope": tol_nz / np.sqrt(np.maximum(1.0 - nz * nz, 1e-12)),
           "traver": tol_nz / np.sqrt(np.maximum(1.0 - nz * nz, 1e-12))}
    tol["slope"] = np.where(nz > 1.0 - 1e-6, np.maximum(tol["slope"], 1e-3),
                            tol["slope"])
    tol["traver"] = np.where(nz > 1.0 - 1e-6,
                             np.maximum(tol["traver"], 1e-3), tol["traver"])
    for k in ("slope", "traver", "normal_z"):
        d = np.abs(getattr(got, k).numpy() - np.asarray(getattr(want, k)))
        bad = d > tol[k]
        assert not bad.any(), (k, d[bad].max(), int(bad.sum()))


@pytest.mark.parametrize("L,start,kind", [(40, (0, 0), "random"),
                                          (33, (13, 30), "random"),
                                          (48, (5, 41), "smooth")])
def test_matches_pallas_interpret(L, start, kind):
    rng = np.random.default_rng(L)
    cfg = MapConfig(length=L, resolution=0.1)
    elev = _terrain(rng, cfg, kind)
    js, ts = _states(cfg, elev, start)
    want = jax.jit(lambda s: compute_features_pallas(s, cfg,
                                                     interpret=True))(js)
    got = tft.plane_fit_features(ts, cfg)
    _check(got, want, elev, start, cfg)
    if kind == "smooth":
        # terrain-like input: well-posed fits everywhere, so the plain 1e-5
        # bound holds except at flat cells (normal_z > 1 - 1e-6)
        nz = np.asarray(want.normal_z)
        steep = (np.asarray(want.traver) != -10.0) & (nz <= 1.0 - 1e-6)
        for k in ("slope", "normal_z", "traver"):
            d = np.abs(getattr(got, k).numpy() - np.asarray(getattr(want, k)))
            assert d[steep].max() <= 1e-5, (k, d[steep].max())


@pytest.mark.parametrize("L,start", [(32, (3, 17)), (45, (44, 0))])
def test_matches_xla_version(L, start):
    rng = np.random.default_rng(100 + L)
    cfg = MapConfig(length=L, resolution=0.2)
    elev = _terrain(rng, cfg, "random")
    js, ts = _states(cfg, elev, start)
    want = jax.jit(lambda s: jcompute(s, cfg))(js)
    _check(tft.compute_features(ts, cfg), want, elev, start, cfg)


def test_flat_ground_and_window_edge():
    """Flat ground: slope 0, traver 1; cells whose 5x5 window leaves the
    geographic grid see fewer neighbours (the masks come from start)."""
    L = 20
    cfg = MapConfig(length=L, resolution=0.2)
    _, ts = _states(cfg, np.full((L, L), 0.5, np.float32), (7, 3))
    f = tft.plane_fit_features(ts, cfg)
    assert float(f.slope.abs().max()) < 1e-3
    assert float((f.traver - 1.0).abs().max()) < 2e-3
    counts = f.neighbor_count.numpy()
    assert counts.max() == 25 and counts.min() == 9
    # the geographic corner (0, 0) lives at storage (start) = (7, 3)
    assert counts[7, 3] == 9


def test_smallest_eig_normal_of_a_tilted_plane():
    """Moments of a plane z = a x + b y: normal_z = 1/sqrt(1 + a^2 + b^2)."""
    g = torch.arange(-2, 3, dtype=torch.float32) * 0.1
    x, y = torch.meshgrid(g, g, indexing="ij")
    z = 0.3 * x - 0.2 * y
    n = float(x.numel())
    acc = {"n": torch.tensor([n]), "Sx": x.sum()[None], "Sy": y.sum()[None],
           "Sz": z.sum()[None], "Sxx": (x * x).sum()[None],
           "Syy": (y * y).sum()[None], "Sxy": (x * y).sum()[None],
           "Sxz": (x * z).sum()[None], "Syz": (y * z).sum()[None],
           "Szz": (z * z).sum()[None]}
    cfg = MapConfig(length=5, resolution=0.1)
    slope, _, _, nz, ok = tft.features_from_moments(acc, torch.tensor([0.0]),
                                                    cfg)
    want = 1.0 / np.sqrt(1 + 0.3 ** 2 + 0.2 ** 2)
    assert bool(ok) and abs(float(nz) - want) < 1e-5
    assert abs(float(slope) - np.arccos(want)) < 1e-4


def test_reference_jit_contracts_multiply_add_into_fma():
    """The first op where the two packages part: in a jitted fusion XLA's CPU
    code computes `c + a * b` with one rounding (an FMA), bitwise the exact
    product-sum rounded once; PyTorch rounds a * b first, as written."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=1 << 14).astype(np.float32) for _ in range(3))
    fused = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    exact_fma = (a.astype(np.float64) * b + c).astype(np.float32)
    got = (torch.from_numpy(c) + torch.from_numpy(a)
           * torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(fused, exact_fma)
    np.testing.assert_array_equal(got, c + a * b)
    assert (fused != got).mean() > 0.05


@pytest.mark.parametrize("t_op,np_op,lo,hi,ulp_each,ulp_apart", [
    ("acos", "arccos", -1.0, 1.0, 2.0, 2.0),     # r of the eigensolver
    ("cos", "cos", 2.0944, 3.1416, 1.0, 1.0),    # phi + 2 pi / 3
])
def test_acos_and_cos_differ_by_ulps_on_the_same_input(t_op, np_op, lo, hi,
                                                       ulp_each, ulp_apart):
    """Both libraries are faithful (within `ulp_each` of the float64 value)
    but not identical: fed the same f32 input they land up to `ulp_apart`
    ULP apart, which an ill-conditioned plane fit amplifies."""
    x = np.random.default_rng(1).uniform(lo, hi, 1 << 14).astype(np.float32)
    j = np.asarray(jax.jit(getattr(jnp, np_op))(x)).astype(np.float64)
    t = getattr(torch, t_op)(torch.from_numpy(x)).numpy().astype(np.float64)
    ref = getattr(np, np_op)(x.astype(np.float64))
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert (np.abs(j - ref) / ulp).max() <= ulp_each
    assert (np.abs(t - ref) / ulp).max() <= ulp_each
    apart = np.abs(j - t) / ulp
    assert 0 < apart.max() <= ulp_apart and (apart > 0).mean() > 0.01
