"""The port's transforms against the JAX package's SHT on the same states
and maps (float64, CPU), plus round trip and adjointness."""

import numpy as np
import jax.numpy as jnp
import pytest

from torch_parity import n, t64
from gibbssampler_tpu.harmonics import ell_mask_state, nstate
from gibbssampler_tpu.sht import legendre as jax_legendre
from gibbssampler_tpu.sht import make_sht as jax_make_sht
from gibbssampler_tpu_torch.sht import (legendre_table, make_sht,
                                        spin2_lambda_tables)

LMAX = 12
ATOL = 1e-12


@pytest.fixture(scope="module")
def pair():
    js = jax_make_sht(LMAX, dtype=jnp.float64, spin2=True)
    ts = make_sht(LMAX, dtype=t64(0.0).dtype, spin2=True, device="cpu")
    return js, ts


def _states(k, lmin, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(k, nstate(LMAX))) * ell_mask_state(LMAX, lmin)


def _maps(ts, k, seed):
    return np.random.default_rng(seed).normal(size=(k, ts.nrings, ts.nphi))


def test_tables_match(pair):
    js, ts = pair
    th = js.grid.theta
    np.testing.assert_allclose(
        legendre_table(LMAX, np.cos(th)),
        jax_legendre._legendre_table_np(LMAX, np.cos(th)), rtol=0, atol=ATOL)
    for mine, ref in zip(spin2_lambda_tables(LMAX, th),
                         jax_legendre.spin2_lambda_tables(LMAX, th)):
        np.testing.assert_allclose(mine, ref, rtol=0, atol=ATOL)
    # the dense device tables against the JAX SHT's (m_block=128 > L: one
    # dense block each)
    for name in ("lam0", "lam_p2", "lam_m2"):
        np.testing.assert_allclose(n(getattr(ts, name)),
                                   n(getattr(js, name)[0]), rtol=0,
                                   atol=ATOL)


def test_spin0_matches_jax(pair):
    js, ts = pair
    x = _states(3, 0, 1)
    f = _maps(ts, 3, 2)
    np.testing.assert_allclose(n(ts.synthesis_state(t64(x))),
                               n(js.synthesis_state(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(n(ts.adjoint_synthesis_state(t64(f))),
                               n(js.adjoint_synthesis_state(jnp.asarray(f))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(n(ts.analysis_state(t64(f))),
                               n(js.analysis_state(jnp.asarray(f))),
                               rtol=0, atol=ATOL)


def test_spin2_matches_jax(pair):
    js, ts = pair
    e, b = _states(2, 2, 3), _states(2, 2, 4)
    q, u = _maps(ts, 2, 5), _maps(ts, 2, 6)
    for mine, ref in zip(
            ts.synthesis_spin2_state(t64(e), t64(b)),
            js.synthesis_spin2_state(jnp.asarray(e), jnp.asarray(b))):
        np.testing.assert_allclose(n(mine), n(ref), rtol=0, atol=ATOL)
    for meth in ("adjoint_synthesis_spin2_state", "analysis_spin2_state"):
        for mine, ref in zip(getattr(ts, meth)(t64(q), t64(u)),
                             getattr(js, meth)(jnp.asarray(q),
                                               jnp.asarray(u))):
            np.testing.assert_allclose(n(mine), n(ref), rtol=0, atol=ATOL)


def test_round_trip_and_adjointness(pair):
    _, ts = pair
    x = _states(2, 0, 7)
    np.testing.assert_allclose(n(ts.analysis_state(ts.synthesis_state(t64(x)))),
                               x, rtol=0, atol=1e-12)
    e, b = _states(2, 2, 8), _states(2, 2, 9)
    e2, b2 = ts.analysis_spin2_state(*ts.synthesis_spin2_state(t64(e),
                                                               t64(b)))
    np.testing.assert_allclose(n(e2), e, rtol=0, atol=1e-12)
    np.testing.assert_allclose(n(b2), b, rtol=0, atol=1e-12)
    q, u = _maps(ts, 2, 10), _maps(ts, 2, 11)
    aq, au = ts.synthesis_spin2_state(t64(e), t64(b))
    ae, ab = ts.adjoint_synthesis_spin2_state(t64(q), t64(u))
    lhs = float((aq * t64(q)).sum() + (au * t64(u)).sum())
    rhs = float((t64(e) * ae).sum() + (t64(b) * ab).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def _cut_pair(lmax, band):
    """The JAX package's SHT and the port's on the same cut subgrid of the
    GL grid (the rings with |lat| <= band, as the cut decomposition takes)."""
    from gibbssampler_tpu.sht import SHT as JaxSHT
    from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl
    from gibbssampler_tpu.sht.grids import subgrid_rows as jax_subgrid
    from gibbssampler_tpu_torch.sht import SHT, gauss_legendre_grid, subgrid_rows
    jg, tg = jax_gl(lmax), gauss_legendre_grid(lmax)
    if band is not None:
        rows = np.where(np.abs(np.pi / 2 - tg.theta) <= band)[0]
        jg, tg = jax_subgrid(jg, rows), subgrid_rows(tg, rows)
    return (JaxSHT(jg, lmax, dtype=jnp.float64, spin2=True),
            SHT(tg, lmax, dtype=t64(0.0).dtype, spin2=True, device="cpu"))


@pytest.mark.parametrize("band", [None, 0.3], ids=["full", "cut"])
def test_transforms_match_jax_on_full_and_cut_grids(band):
    """Through the Legendre stage's strided views: spin-0 and spin-2
    synthesis and adjoint synthesis equal the JAX package's (lmax 32)."""
    lmax = 32
    js, ts = _cut_pair(lmax, band)
    rng = np.random.default_rng(12)
    k = 3
    x = rng.normal(size=(k, nstate(lmax))) * ell_mask_state(lmax, 0)
    e, b = (rng.normal(size=(k, nstate(lmax))) * ell_mask_state(lmax, 2)
            for _ in range(2))
    f, q, u = (rng.normal(size=(k, ts.nrings, ts.nphi)) for _ in range(3))
    pairs = [(ts.synthesis_state(t64(x)),
              js.synthesis_state(jnp.asarray(x))),
             (ts.adjoint_synthesis_state(t64(f)),
              js.adjoint_synthesis_state(jnp.asarray(f)))]
    pairs += zip(ts.synthesis_spin2_state(t64(e), t64(b)),
                 js.synthesis_spin2_state(jnp.asarray(e), jnp.asarray(b)))
    pairs += zip(ts.adjoint_synthesis_spin2_state(t64(q), t64(u)),
                 js.adjoint_synthesis_spin2_state(jnp.asarray(q),
                                                  jnp.asarray(u)))
    for mine, ref in pairs:
        np.testing.assert_allclose(n(mine), n(ref), rtol=0, atol=ATOL)


def test_legendre_stage_passes_state_views(pair, monkeypatch):
    """``_lsynth_stack`` hands the kernels the state's grids as a strided
    (m, C, l) view, without a copy; ``_ladj_stack`` hands them g with unit
    stride on r and returns contiguous state-order grids."""
    from gibbssampler_tpu_torch.sht import lcore
    from gibbssampler_tpu_torch.sht import legendre_kernels as lk
    _, ts = pair
    seen = {}

    def recording(name, fn):
        def wrapped(lam, b):
            seen[name] = b
            return fn(lam, b)
        return wrapped

    monkeypatch.setattr(lcore, "legendre_synth_tri",
                        recording("x", lk.legendre_synth_tri))
    monkeypatch.setattr(lcore, "legendre_adj_tri",
                        recording("g", lk.legendre_adj_tri))
    L = LMAX + 1
    grids = t64(np.random.default_rng(13).normal(size=(3, 2, L, L)))
    ts._lsynth_stack(ts.lam0, grids)
    x = seen["x"]
    assert x.shape == (L, 6, L) and x.stride() == (L, L * L, 1)
    assert x.data_ptr() == grids.data_ptr()
    G = t64(np.random.default_rng(14).normal(size=(3, 2, ts.nrings, L)))
    a = ts._ladj_stack(ts.lam0, G)
    assert seen["g"].shape == (L, ts.nrings, 6) and seen["g"].stride(1) == 1
    assert a.shape == (3, 2, L, L) and a.is_contiguous()
