"""The port's real (flat) and healpy-order alm interface against the JAX
package (float64, CPU): the packing conversions, the flat-packing spectra
and variance expansions, flat <-> grid-packed state, the flat methods of
SHT and HealpixSHT, and ``inference.synfast``.  Each test mirrors one of
tests/test_harmonics.py, tests/test_gridstate.py, tests/test_sht.py or
tests/test_healpix.py on the same numpy inputs in both packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import n, t64
import gibbssampler_tpu.harmonics as jh
import gibbssampler_tpu_torch.harmonics as th

LMAX = 9
NSIDE = 8


def _flat(seed, batch=(), lmax=LMAX):
    return np.random.default_rng(seed).normal(size=batch + (th.nflat(lmax),))


def _same(mine, ref, rtol=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(mine), ref, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


def test_index_maps_match_jax():
    """The copied index tables equal JAX's, the healpy ones included."""
    mine, ref = th.index_maps(LMAX), jh.index_maps(LMAX)
    for name in ("ell_of", "m_of", "is_imag", "grid_re_src", "grid_im_src",
                 "grid_re_scale", "grid_im_scale", "flat_scale",
                 "hp_of_flat", "hp_ell", "hp_m"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(ref, name), err_msg=name)
    assert th.nhealpy(LMAX) == jh.nhealpy(LMAX)


def test_flat_grid_roundtrip():
    """Mirror of test_harmonics.py::test_flat_grid_roundtrip."""
    flat = _flat(0, (3,))
    re, im = th.flat_to_grid(t64(flat), LMAX)
    jre, jim = jh.flat_to_grid(jnp.asarray(flat), LMAX)
    _same(re, jre)
    _same(im, jim)
    _same(th.grid_to_flat(re, im, LMAX), flat)


def test_flat_healpy_roundtrip():
    """Mirror of test_harmonics.py::test_flat_healpy_roundtrip: complex
    healpy-order alm equal to JAX's, and back to within the rounding of
    the sqrt(2) scale."""
    flat = _flat(1)
    alm = th.flat_to_healpy(t64(flat), LMAX)
    assert alm.shape == (th.nhealpy(LMAX),) and alm.is_complex()
    _same(alm, jh.flat_to_healpy(jnp.asarray(flat), LMAX))
    back = th.healpy_to_flat(alm, LMAX)
    _same(back, jh.healpy_to_flat(jnp.asarray(n(alm)), LMAX))
    # the sqrt(2) scale and its inverse round once each
    np.testing.assert_allclose(n(back), flat, rtol=4.5e-16, atol=0)


def test_healpy_index_formula():
    """Mirror of test_harmonics.py::test_healpy_index_formula."""
    maps = th.index_maps(LMAX)
    for i in [0, 5, LMAX + 1, th.nflat(LMAX) - 1]:
        m, l = int(maps.m_of[i]), int(maps.ell_of[i])
        assert maps.hp_of_flat[i] == m * (2 * LMAX + 1 - m) // 2 + l


def test_dl_cl_roundtrip():
    """Mirror of test_harmonics.py::test_dl_cl_roundtrip."""
    dl = np.random.default_rng(0).uniform(0.5, 2.0, LMAX + 1)
    cl = th.dl_to_cl(t64(dl))
    assert float(cl[0]) == 0.0 and float(cl[1]) == 0.0
    back = th.cl_to_dl(cl)
    _same(back, jh.cl_to_dl(jh.dl_to_cl(jnp.asarray(dl))))
    np.testing.assert_allclose(n(back)[2:], dl[2:], rtol=1e-12)


def test_variance_expansion_matches_formula():
    """Mirror of test_harmonics.py::test_variance_expansion_matches_formula,
    and JAX's values (with a chain axis)."""
    dl = np.random.default_rng(1).uniform(0.5, 2.0, (2, LMAX + 1))
    var = n(th.variance_expansion(t64(dl), LMAX))
    _same(var, jax.vmap(lambda d: jh.variance_expansion(d, LMAX))(
        jnp.asarray(dl)))
    maps = th.index_maps(LMAX)
    for i in range(th.nflat(LMAX)):
        l = int(maps.ell_of[i])
        expected = 0.0 if l < 2 else dl[0, l] * 2 * np.pi / (l * (l + 1))
        assert np.isclose(var[0, i], expected), (i, l)


def test_variance_expansion_matrix():
    """Mirror of test_harmonics.py::test_variance_expansion_matrix."""
    blocks = np.random.default_rng(2).uniform(0.5, 2.0, (LMAX + 1, 3, 3))
    out = n(th.variance_expansion_matrix(t64(blocks), LMAX))
    assert out.shape == (th.nflat(LMAX), 3, 3)
    _same(out, jh.variance_expansion_matrix(jnp.asarray(blocks), LMAX))
    maps = th.index_maps(LMAX)
    i = np.where((maps.ell_of == 4) & (maps.m_of == 3) & maps.is_imag)[0][0]
    np.testing.assert_allclose(out[i], blocks[4] * 2 * np.pi / 20,
                               rtol=1e-12)


def test_alm2cl_parseval():
    """Mirror of test_harmonics.py::test_alm2cl_parseval: 1/(2l+1) sum_m
    |a_lm|^2 of the complex alm, JAX's auto and cross spectra."""
    flat, flat2 = _flat(3, (2,)), _flat(4, (2,))
    cl = n(th.alm2cl(t64(flat), LMAX))
    _same(cl, jax.vmap(lambda x: jh.alm2cl(x, LMAX))(jnp.asarray(flat)))
    _same(th.alm2cl(t64(flat), LMAX, t64(flat2)),
          jax.vmap(lambda x, y: jh.alm2cl(x, LMAX, y))(jnp.asarray(flat),
                                                       jnp.asarray(flat2)))
    alm = n(th.flat_to_healpy(t64(flat[0]), LMAX))
    for l in range(LMAX + 1):
        tot = sum((1.0 if m == 0 else 2.0)
                  * abs(alm[m * (2 * LMAX + 1 - m) // 2 + l]) ** 2
                  for m in range(l + 1))
        assert np.isclose(cl[0, l], tot / (2 * l + 1)), l


def test_almxfl():
    """Mirror of test_harmonics.py::test_almxfl."""
    flat = _flat(5)
    fl = np.random.default_rng(5).uniform(0.5, 2.0, LMAX + 1)
    out = th.almxfl(t64(flat), t64(fl), LMAX)
    _same(out, jh.almxfl(jnp.asarray(flat), jnp.asarray(fl), LMAX))
    np.testing.assert_allclose(n(th.alm2cl(out, LMAX)),
                               n(th.alm2cl(t64(flat), LMAX)) * fl ** 2,
                               rtol=1e-10)


GLMAX = 24


def test_flat_state_roundtrip():
    """Mirror of test_gridstate.py::test_flat_state_roundtrip: JAX's state,
    and state_to_flat(flat_to_state(a)) == a exactly."""
    x = _flat(6, (3,), GLMAX)
    st = th.flat_to_state(t64(x), GLMAX)
    assert st.shape == (3, th.nstate(GLMAX))
    _same(st, jh.flat_to_state(jnp.asarray(x), GLMAX), rtol=0)
    assert torch.equal(th.state_to_flat(st, GLMAX), t64(x))


def test_variance_expansion_state_matches_flat():
    """Mirror of test_gridstate.py::test_variance_expansion_state_matches_
    flat."""
    dl = t64(np.random.default_rng(0).uniform(0.5, 2.0, GLMAX + 1))
    vs = th.variance_expansion_state(dl, GLMAX)
    assert torch.equal(th.state_to_flat(vs, GLMAX),
                       th.variance_expansion(dl, GLMAX))
    valid = th.ell_mask_state(GLMAX, lmin=0)
    assert np.all(n(vs)[valid == 0] == 0.0)


def test_almxfl_alm2cl_state_match_flat():
    """Mirror of test_gridstate.py::test_almxfl_alm2cl_state_match_flat."""
    x, y = t64(_flat(7, (2,), GLMAX)), t64(_flat(8, (2,), GLMAX))
    st = th.flat_to_state(x, GLMAX)
    fl = t64(np.random.default_rng(1).uniform(0.5, 2.0, GLMAX + 1))
    assert torch.equal(th.state_to_flat(th.almxfl_state(st, fl, GLMAX),
                                        GLMAX), th.almxfl(x, fl, GLMAX))
    _same(th.alm2cl_state(st, GLMAX), th.alm2cl(x, GLMAX))
    _same(th.alm2cl_state(st, GLMAX, th.flat_to_state(y, GLMAX)),
          th.alm2cl(x, GLMAX, y))


@pytest.fixture(scope="module")
def shts():
    """The GL SHT at lmax 24 in both packages (spin 0 and 2)."""
    from gibbssampler_tpu.sht import make_sht as jmake
    from gibbssampler_tpu_torch.sht import make_sht
    return (jmake(GLMAX, dtype=jnp.float64, spin2=True),
            make_sht(GLMAX, dtype=torch.float64, spin2=True, device="cpu"))


def test_sht_state_methods_match_flat(shts):
    """Mirror of test_gridstate.py::test_sht_state_methods_match_flat: each
    flat method wraps its state method exactly, and equals JAX's."""
    js, ts = shts
    e, b = t64(_flat(9, (), GLMAX)), t64(_flat(10, (), GLMAX))
    es, bs = th.flat_to_state(e, GLMAX), th.flat_to_state(b, GLMAX)
    assert torch.equal(ts.synthesis(e), ts.synthesis_state(es))
    _same(ts.synthesis(e), js.synthesis(jnp.asarray(n(e))))
    q, u = ts.synthesis_spin2(e, b)
    q2, u2 = ts.synthesis_spin2_state(es, bs)
    assert torch.equal(q, q2) and torch.equal(u, u2)
    assert torch.equal(ts.analysis(q),
                       th.state_to_flat(ts.analysis_state(q), GLMAX))
    _same(ts.analysis(q), js.analysis(jnp.asarray(n(q))))
    for a, r in zip(ts.analysis_spin2(q, u),
                    js.analysis_spin2(jnp.asarray(n(q)), jnp.asarray(n(u)))):
        _same(a, r)


def test_roundtrip_spin0(shts):
    """Mirror of test_sht.py::test_roundtrip_spin0."""
    _, ts = shts
    flat = t64(_flat(11, (), GLMAX))
    m = ts.synthesis(flat)
    assert m.shape == (ts.nrings, ts.nphi)
    np.testing.assert_allclose(n(ts.analysis(m)), n(flat), atol=1e-11)


def _l2mask(lmax):
    return t64(th.index_maps(lmax).ell_of >= 2)


def test_roundtrip_spin2(shts):
    """Mirror of test_sht.py::test_roundtrip_spin2 (l < 2 slots zero)."""
    _, ts = shts
    e = t64(_flat(12, (), GLMAX)) * _l2mask(GLMAX)
    b = t64(_flat(13, (), GLMAX)) * _l2mask(GLMAX)
    e2, b2 = ts.analysis_spin2(*ts.synthesis_spin2(e, b))
    np.testing.assert_allclose(n(e2), n(e), atol=1e-11)
    np.testing.assert_allclose(n(b2), n(b), atol=1e-11)


def _adjoint_gap(sht, npix_shape, lmax, spin, seed):
    """|<A x, y> - <x, A^T y>| / max(1, |<A x, y>|) on the flat methods."""
    rng = np.random.default_rng(seed)
    if spin == 0:
        x = t64(rng.normal(size=th.nflat(lmax)))
        y = t64(rng.normal(size=npix_shape))
        lhs = float((sht.synthesis(x) * y).sum())
        rhs = float((x * sht.adjoint_synthesis(y)).sum())
    else:
        e, b = (t64(rng.normal(size=th.nflat(lmax))) * _l2mask(lmax)
                for _ in range(2))
        q, u = (t64(rng.normal(size=npix_shape)) for _ in range(2))
        qs, us = sht.synthesis_spin2(e, b)
        ea, ba = sht.adjoint_synthesis_spin2(q, u)
        lhs = float((qs * q).sum() + (us * u).sum())
        rhs = float((e * ea).sum() + (b * ba).sum())
    return abs(lhs - rhs) / max(1.0, abs(lhs))


@pytest.mark.parametrize("spin", [0, 2])
def test_adjointness(shts, spin):
    """Mirror of test_sht.py::test_adjointness_spin0 / _spin2 on the flat
    methods; the adjoint equals JAX's."""
    js, ts = shts
    assert _adjoint_gap(ts, (ts.nrings, ts.nphi), GLMAX, spin, 14) < 1e-10
    y = np.random.default_rng(15).normal(size=(ts.nrings, ts.nphi))
    if spin == 0:
        _same(ts.adjoint_synthesis(t64(y)),
              js.adjoint_synthesis(jnp.asarray(y)))
    else:
        for a, r in zip(ts.adjoint_synthesis_spin2(t64(y), t64(2 * y)),
                        js.adjoint_synthesis_spin2(jnp.asarray(y),
                                                   jnp.asarray(2 * y))):
            _same(a, r)


@pytest.fixture(scope="module")
def hshts():
    """The HEALPix SHT at nside 8, lmax 16, RING layout, in both
    packages."""
    from gibbssampler_tpu.sht.healpix import make_healpix_sht as jmake
    from gibbssampler_tpu_torch.sht import make_healpix_sht
    return (jmake(NSIDE, dtype=jnp.float64, spin2=True),
            make_healpix_sht(NSIDE, dtype=torch.float64, spin2=True,
                             device="cpu"))


@pytest.mark.parametrize("spin", [0, 2])
def test_healpix_adjointness(hshts, spin):
    """Mirror of test_healpix.py::test_adjointness_spin0 / _spin2 on the
    flat methods; synthesis and adjoint equal JAX's."""
    js, ts = hshts
    lmax, npix = ts.lmax, 12 * NSIDE ** 2
    assert _adjoint_gap(ts, (npix,), lmax, spin, 16) < 1e-10
    rng = np.random.default_rng(17)
    x, y = rng.normal(size=th.nflat(lmax)), rng.normal(size=npix)
    if spin == 0:
        _same(ts.synthesis(t64(x)), js.synthesis(jnp.asarray(x)))
        _same(ts.adjoint_synthesis(t64(y)),
              js.adjoint_synthesis(jnp.asarray(y)))
    else:
        for a, r in zip(ts.synthesis_spin2(t64(x), t64(-x)),
                        js.synthesis_spin2(jnp.asarray(x),
                                           jnp.asarray(-x))):
            _same(a, r)
        for a, r in zip(ts.adjoint_synthesis_spin2(t64(y), t64(y)),
                        js.adjoint_synthesis_spin2(jnp.asarray(y),
                                                   jnp.asarray(y))):
            _same(a, r)


def test_healpix_analysis_approximate_roundtrip(hshts):
    """Mirror of test_healpix.py::test_analysis_approximate_roundtrip:
    iter=0 analysis is an approximate inverse (a few percent at l <=
    nside); equal to JAX's."""
    js, ts = hshts
    lmax = ts.lmax
    flat = _flat(18, (), lmax) * (th.index_maps(lmax).ell_of <= NSIDE)
    back = ts.analysis(ts.synthesis(t64(flat)))
    _same(back, js.analysis(js.synthesis(jnp.asarray(flat))))
    err = float(np.linalg.norm(n(back) - flat) / np.linalg.norm(flat))
    assert err < 0.05, err


@pytest.mark.parametrize("grid,spin", [("gl", 2), ("healpix", 0)])
def test_synfast_matches_jax(shts, hshts, grid, spin):
    """synfast with injected normals equals JAX's synfast on the normals
    JAX draws from the same key: the alm state and the maps."""
    from gibbssampler_tpu.inference import example_dl
    from gibbssampler_tpu.inference import synfast as jax_synfast
    from gibbssampler_tpu_torch.inference import synfast
    js, ts = shts if grid == "gl" else hshts
    lmax = ts.lmax
    kinds = ("tt",) if spin == 0 else ("ee", "bb")
    dl = np.stack([example_dl(lmax, k, amp=10.0) for k in kinds])
    key = jax.random.PRNGKey(19)
    ja, jm = jax_synfast(key, dl, js, spin)
    xi = np.asarray(jax.random.normal(key, (len(kinds), th.nstate(lmax)),
                                      dtype=jnp.float64))
    alm, maps = synfast(dl, ts, spin, xi=t64(xi))
    assert alm.device == maps.device == ts.device
    _same(alm, ja)
    _same(maps, jm)
    # drawn from a generator: the same shapes, a seeded draw repeats
    a1, m1 = synfast(dl, ts, spin, gen=torch.Generator().manual_seed(0))
    a2, _ = synfast(dl, ts, spin, gen=torch.Generator().manual_seed(0))
    assert torch.equal(a1, a2) and m1.shape == maps.shape
    with pytest.raises(ValueError):
        synfast(np.stack([dl[0]] * 3), ts, 3)
