"""The port's HEALPix grid against the JAX package (float64, CPU, nside 8 /
lmax 16; the mirror of tests/test_healpix.py and the HEALPix cases of
tests/test_cut.py and tests/test_sparse.py): geometry, the padded layout
and the pixel functions, ``HealpixSHT`` in both layouts, ``white_healpix``,
the belt-row cut with cap-ring holes in the point set, the CR steps, the
table engine's ring-phase and Nyquist paths and three ASIS iterations on
the same variates; and the sizes of bench.py's nside-256 planckish split,
counted on the host."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_mh_uniforms, make_holey_healpix,
                          make_masked_healpix, n, planckish_healpix_mask,
                          port_model, t64, valid_normal)
from gibbssampler_tpu.harmonics import variance_expansion_state
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.ops import NoiseModel as JaxNoise
from gibbssampler_tpu.ops.model import healpix_belt_rows as jax_belt_rows
from gibbssampler_tpu.samplers import aux_gibbs_cr as jax_aux_gibbs
from gibbssampler_tpu.samplers import aux_then_mala_cr as jax_aux_mala
from gibbssampler_tpu.samplers import cls_samplers as jcs
from gibbssampler_tpu.samplers import mala_cr as jax_mala
from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu.sht import healpix as jhp
from gibbssampler_tpu.sht import healpix_pix as jpix
from gibbssampler_tpu_torch.harmonics import nstate
from gibbssampler_tpu_torch.interop import state_from_numpy
from gibbssampler_tpu_torch.ops import (NoiseModel, healpix_belt_rows,
                                        healpix_cut_weights)
from gibbssampler_tpu_torch.samplers import (aux_gibbs_cr, aux_then_mala_cr,
                                             mala_cr)
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.schemes import ASISGibbs
from gibbssampler_tpu_torch.sht import (ang2pix_ring,
                                        galactic_band_mask,
                                        group_points_by_ring,
                                        healpix_geometry, healpix_layout,
                                        make_healpix_sht, pix2ang_ring,
                                        ud_grade)
from gibbssampler_tpu_torch.sht.healpix import _cap_classes

NSIDE = 8
LMAX = 2 * NSIDE
NCH = 3
RTOL = 1e-9
OPTS = {"n_gibbs": 1, "tau": 0.02}


def _check(mine, ref, what, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(mine), ref, rtol=rtol,
                               atol=rtol * max(1e-300,
                                               float(np.abs(ref).max())),
                               err_msg=what)


@pytest.fixture(scope="module")
def shts():
    """{layout: (JAX HealpixSHT, port HealpixSHT)}, spin 2, float64."""
    return {lay: (jhp.make_healpix_sht(NSIDE, LMAX, dtype=jnp.float64,
                                       spin2=True, layout=lay),
                  make_healpix_sht(NSIDE, LMAX, dtype=torch.float64,
                                   spin2=True, layout=lay, device="cpu"))
            for lay in ("ring", "padded")}


@pytest.fixture(scope="module")
def holey():
    """{(spin, layout): (JAX full model, JAX split model, port split
    model)} on the holey HEALPix mask, built on first use."""
    cache = {}

    def get(spin=2, layout="padded"):
        if (spin, layout) not in cache:
            model, mc, fields = make_holey_healpix(spin=spin, layout=layout)
            cache[spin, layout] = (model, mc, port_model(model, cut=True),
                                   fields)
        return cache[spin, layout]
    return get


# ---------------------------------------------------------------------------
# Geometry, layout and pixel functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nside", [1, 2, 8])
def test_geometry_and_layout_match_jax(nside):
    """Ring table, cap width classes (lane 128, so also at nside 256) and
    the padded layout's slot maps equal JAX's."""
    geo, jgeo = healpix_geometry(nside), jhp.healpix_geometry(nside)
    for name in ("theta", "nphi", "phi0", "ring_start"):
        np.testing.assert_array_equal(getattr(geo, name),
                                      getattr(jgeo, name), err_msg=name)
    assert (geo.npix, geo.nrings, geo.pixel_area) == (
        jgeo.npix, jgeo.nrings, jgeo.pixel_area)
    for ncap in (nside - 1, 7, 63, 64, 255):
        assert _cap_classes(ncap) == jhp._cap_classes(ncap)
    lay = healpix_layout(nside, "padded")
    jsht = jhp.make_healpix_sht(nside, 2 * nside, dtype=jnp.float64,
                                layout="padded")
    assert lay.cap_classes == jsht.cap_classes
    assert (lay.npadded, lay.belt_off) == (jsht.npadded, jsht._belt_off)
    np.testing.assert_array_equal(lay.pix_of, np.asarray(jsht._pix_of))
    np.testing.assert_array_equal(lay.src_of, np.asarray(jsht._src_of))
    np.testing.assert_array_equal(lay.valid, np.asarray(jsht._src_valid))


@pytest.mark.parametrize("nside", [1, 2, 8])
def test_pixel_functions_match_jax(nside):
    """pix2ang, ang2pix (round trip and random angles), ud_grade and the
    band masks equal JAX's."""
    npix = 12 * nside * nside
    th, ph = pix2ang_ring(nside, np.arange(npix))
    jth, jph = jpix.pix2ang_ring(nside, np.arange(npix))
    np.testing.assert_array_equal(th, jth)
    np.testing.assert_array_equal(ph, jph)
    np.testing.assert_array_equal(ang2pix_ring(nside, th, ph), np.arange(npix))
    rng = np.random.default_rng(nside)
    t, p = np.arccos(rng.uniform(-1, 1, 500)), rng.uniform(0, 7, 500)
    np.testing.assert_array_equal(ang2pix_ring(nside, t, p),
                                  jpix.ang2pix_ring(nside, t, p))
    for args in ((10.0,), (10.0, 5.0)):
        np.testing.assert_array_equal(galactic_band_mask(nside, *args),
                                      jpix.galactic_band_mask(nside, *args))
    m = rng.uniform(size=(2, npix))
    for out in (max(1, nside // 2), 2 * nside):
        np.testing.assert_array_equal(ud_grade(m, out),
                                      jpix.ud_grade(m, out))


# ---------------------------------------------------------------------------
# HealpixSHT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["ring", "padded"])
def test_healpix_sht_matches_jax(shts, layout):
    """Spin-0 and spin-2 synthesis, adjoint and analysis over a chain axis
    against JAX's vmapped transforms, and the Legendre tables over all
    4 nside - 1 rings."""
    jsht, tsht = shts[layout]
    for name in ("lam0", "lam_p2", "lam_m2"):
        _check(getattr(tsht, name), jnp.concatenate(getattr(jsht, name)),
               name, rtol=1e-13)
    rng = np.random.default_rng(0)
    ns = nstate(LMAX)
    x, e, b = (valid_normal(rng, (NCH, ns), LMAX, lmin=0) for _ in range(3))
    npx = tsht.npix_layout
    valid = np.ones(npx) if layout == "ring" else n(tsht.valid)
    f, g = (rng.normal(size=(NCH, npx)) * valid for _ in range(2))
    vm = jax.vmap
    _check(tsht.synthesis_state(t64(x)),
           vm(jsht.synthesis_state)(jnp.asarray(x)), "spin0 synthesis")
    _check(tsht.adjoint_synthesis_state(t64(f)),
           vm(jsht.adjoint_synthesis_state)(jnp.asarray(f)),
           "spin0 adjoint")
    _check(tsht.analysis_state(t64(f)),
           vm(lambda y: jsht.adjoint_synthesis_state(y)
              * jsht.pixel_area)(jnp.asarray(f)), "spin0 analysis")
    mine = tsht.synthesis_spin2_state(t64(e), t64(b))
    ref = vm(jsht.synthesis_spin2_state)(jnp.asarray(e), jnp.asarray(b))
    for a, r, k in zip(mine, ref, "QU"):
        _check(a, r, f"spin2 synthesis {k}")
    mine = tsht.adjoint_synthesis_spin2_state(t64(f), t64(g))
    ref = vm(jsht.adjoint_synthesis_spin2_state)(jnp.asarray(f),
                                                 jnp.asarray(g))
    for a, r, k in zip(mine, ref, "EB"):
        _check(a, r, f"spin2 adjoint {k}")
    mine = tsht.analysis_spin2_state(t64(f), t64(g))
    ref = vm(jsht.analysis_spin2_state)(jnp.asarray(f), jnp.asarray(g))
    for a, r, k in zip(mine, ref, "EB"):
        _check(a, r, f"spin2 analysis {k}")


@pytest.mark.parametrize("layout", ["ring", "padded"])
def test_healpix_adjointness(shts, layout):
    """<A x, y> = <x, A^T y>, spin 0 and spin 2 (mirror of
    test_adjointness_spin0/2 and test_padded_adjointness_spin2)."""
    _, tsht = shts[layout]
    rng = np.random.default_rng(1)
    ns = nstate(LMAX)
    valid = 1.0 if layout == "ring" else tsht.valid
    x = t64(valid_normal(rng, (ns,), LMAX, lmin=0))
    e, b = (t64(valid_normal(rng, (ns,), LMAX)) for _ in range(2))
    y, q, u = (t64(rng.normal(size=tsht.npix_layout)) * valid
               for _ in range(3))
    lhs = float((tsht.synthesis_state(x) * y).sum())
    rhs = float((x * tsht.adjoint_synthesis_state(y)).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))
    qs, us = tsht.synthesis_spin2_state(e, b)
    ea, ba = tsht.adjoint_synthesis_spin2_state(q, u)
    lhs = float((qs * q).sum() + (us * u).sum())
    rhs = float((e * ea).sum() + (b * ba).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_padded_layout_matches_ring(shts):
    """Padded synthesis is the ring synthesis up to ``to_ring``,
    ``from_ring`` inverts it, synthesis is exactly 0 on padding, and the
    adjoint ignores whatever sits on padding (the null space)."""
    _, ring = shts["ring"]
    _, pad = shts["padded"]
    rng = np.random.default_rng(2)
    ns = nstate(LMAX)
    e, b = (t64(valid_normal(rng, (2, ns), LMAX)) for _ in range(2))
    q_r, u_r = ring.synthesis_spin2_state(e, b)
    q_p, u_p = pad.synthesis_spin2_state(e, b)
    assert q_p.shape == (2, pad.npadded)
    _check(pad.to_ring(q_p), n(q_r), "to_ring(Q)", rtol=1e-12)
    _check(pad.from_ring(u_r), n(u_p), "from_ring(U)", rtol=1e-12)
    off = n(pad.valid) == 0.0
    assert off.any() and not n(q_p)[:, off].any() and not n(u_p)[:, off].any()
    y = t64(rng.normal(size=(2, ring.geo.npix)))
    a_ring = ring.adjoint_synthesis_spin2_state(y, 2 * y)
    trash = t64(rng.normal(size=(2, pad.npadded))) * (1.0 - pad.valid)
    yp = pad.from_ring(y) + 100.0 * trash
    a_pad = pad.adjoint_synthesis_spin2_state(yp, 2 * yp)
    for a, r, k in zip(a_pad, a_ring, "EB"):
        _check(a, n(r), f"padded adjoint {k}", rtol=1e-12)


def test_white_healpix_matches_jax(shts):
    """white_healpix in RING order and in the padded layout (q_map = valid,
    tau 0 on padding), and f_sky / tau_max over flat maps."""
    mask = galactic_band_mask(NSIDE, 20.0)
    for layout, (jsht, tsht) in shts.items():
        ref = JaxNoise.white_healpix(np.array([0.5, 0.25]), jsht.geo, 2,
                                     mask=mask, dtype=jnp.float64, sht=jsht)
        mine = NoiseModel.white_healpix(np.array([0.5, 0.25]), tsht.geo, 2,
                                        mask=mask, dtype=torch.float64,
                                        sht=tsht, device="cpu")
        assert mine.pix_ndim == 1 and mine.omega == ref.omega
        for name in ("tau", "q_map", "inv_noise", "tau_max", "f_sky"):
            _check(getattr(mine, name), getattr(ref, name),
                   f"{layout} {name}", rtol=1e-14)
        if layout == "padded":
            assert not n(mine.tau)[:, n(tsht.valid) == 0].any()


def test_aliased_sht_refuses_analysis():
    """SHT(allow_aliasing=True) takes nphi = 2 lmax for synthesis and its
    adjoint only, as in JAX; without the flag such a grid raises."""
    from gibbssampler_tpu.sht import SHT as JaxSHT
    from gibbssampler_tpu_torch.sht import SHT, gauss_legendre_grid
    grid = dataclasses.replace(gauss_legendre_grid(LMAX), nphi=2 * LMAX)
    with pytest.raises(ValueError):
        SHT(grid, LMAX, dtype=torch.float64, spin2=True, device="cpu")
    sht = SHT(grid, LMAX, dtype=torch.float64, spin2=True, device="cpu",
              allow_aliasing=True)
    jsht = JaxSHT(grid, LMAX, dtype=jnp.float64, spin2=True,
                  allow_aliasing=True)
    rng = np.random.default_rng(3)
    e, b = (valid_normal(rng, (nstate(LMAX),), LMAX) for _ in range(2))
    for a, r in zip(sht.synthesis_spin2_state(t64(e), t64(b)),
                    jsht.synthesis_spin2_state(jnp.asarray(e),
                                               jnp.asarray(b))):
        _check(a, r, "aliased synthesis")
    q = t64(rng.normal(size=(grid.nrings, grid.nphi)))
    with pytest.raises(ValueError):
        sht.analysis_spin2_state(q, q)
    with pytest.raises(ValueError):
        sht.analysis_state(q)


# ---------------------------------------------------------------------------
# The HEALPix cut decomposition
# ---------------------------------------------------------------------------

# (maker, spin, layout): the band mask (belt rings only, no split) and the
# holey mask (cap-ring holes, split)
CUTS = [("band", 0, "padded"), ("band", 2, "padded"), ("band", 2, "ring"),
        ("holey", 2, "padded"), ("holey", 2, "ring"), ("holey", 0, "padded")]


def _cut_pair(kind, spin, layout):
    if kind == "band":
        model, mc, fields = make_masked_healpix(spin=spin, layout=layout)
    else:
        model, mc, fields = make_holey_healpix(spin=spin, layout=layout)
    return model, mc, port_model(model, cut=True,
                                 sparse_split=None if kind == "band"
                                 else True), fields


@pytest.mark.parametrize("kind,spin,layout", CUTS)
def test_healpix_cut_matches_jax(kind, spin, layout):
    """The same floor rows (with their phi0), d_cut, w_cut, c0, c1, point
    set, w_sp and d_sp as JAX's HEALPix cut; the floor transform sits at
    nphi = 2 lmax with phased rows."""
    model, mc, tc, _ = _cut_pair(kind, spin, layout)
    cut, jcut = tc.cut_sht, mc.cut_sht
    assert cut.nphi == jcut.nphi == 2 * LMAX and cut.allow_aliasing
    assert cut.has_phase and tc.cut_w_uniform and tc.cut_w_equal_fields
    for name in ("theta", "phi0", "weights"):
        np.testing.assert_array_equal(getattr(cut.grid, name),
                                      getattr(jcut.grid, name), err_msg=name)
    for name in ("d_cut", "w_cut", "cut_c0", "cut_c1"):
        _check(getattr(tc, name), getattr(mc, name), name, rtol=1e-12)
    assert tc.has_sparse == mc.has_sparse == (kind == "holey")
    if kind == "holey":
        sp, jsp = tc.sp_sht, mc.sp_sht
        assert (sp.nrows, sp.p, sp.nslots) == (jsp.nrows, jsp.p, jsp.nslots)
        for name in ("valid", "cosT", "sinT", "cosF", "sinF"):
            np.testing.assert_array_equal(n(getattr(sp, name)),
                                          np.asarray(getattr(jsp, name)))
        for name in ("w_sp", "d_sp"):
            _check(getattr(tc, name), getattr(mc, name), name, rtol=1e-12)
        # holes on cap rings (varying ring lengths) join the point set
        geo = healpix_geometry(NSIDE)
        caps = (sp.theta < geo.theta[NSIDE - 1]) | (
            sp.theta > geo.theta[3 * NSIDE - 1])
        assert caps.any()
    else:
        tau = n(tc.noise.tau)
        cols = np.where((tau < tau.max(axis=1, keepdims=True)).any(0)
                        & (n(tc.noise.q_map) > 0))[0]
        rows, idx = healpix_belt_rows(tc.sht.lay, cols)
        jrows, jidx = jax_belt_rows(mc.sht, cols)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(idx, jidx)


def test_healpix_cut_without_split_refuses_cap_holes():
    """Without the split a mask off the belt rings raises ValueError, in
    both packages; with it (the default here) the cap holes go to the
    point set."""
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    model, mc, _ = make_holey_healpix(spin=2, sparse_split=True)
    with pytest.raises(ValueError):
        jax_cut(model, sparse_split=False)
    tm = port_model(model)
    with pytest.raises(ValueError):
        with_cut_decomposition(tm, sparse_split=False)
    assert with_cut_decomposition(tm).has_sparse


@pytest.mark.parametrize("spin,layout", [(0, "padded"), (2, "padded"),
                                         (2, "ring")])
def test_healpix_cut_transform_exact(spin, layout):
    """Mirror of test_healpix_cut_transform_exact: the belt-row cut
    synthesis equals the full HEALPix synthesis at those pixels (1e-13)
    and its adjoint is the exact transpose."""
    model, mc, fields = make_masked_healpix(spin=spin, layout=layout)
    tc = port_model(model, cut=True)
    rng = np.random.default_rng(1)
    s = t64(valid_normal(rng, (NCH, model.nfields, model.nstate), LMAX))
    full = n(tc.synthesis(s))
    cut = n(tc.synthesis_cut(s))
    tau = n(tc.noise.tau)
    cols = np.where((tau < tau.max(axis=1, keepdims=True)).any(0)
                    & (n(tc.noise.q_map) > 0))[0]
    _, idx = healpix_belt_rows(tc.sht.lay, cols)
    np.testing.assert_allclose(cut, full[..., idx],
                               atol=1e-13 * np.abs(full).max())
    f = t64(rng.normal(size=cut.shape))
    lhs = float((t64(cut) * f).sum())
    rhs = float((s * tc.adjoint_synthesis_cut(f)).sum())
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


@pytest.mark.parametrize("kind,spin,layout", CUTS[1:5])
def test_healpix_cut_operators_match_jax(kind, spin, layout):
    """data_loglike_cut and q_apply_cut over a chain axis equal JAX's on
    the same cut model; the cut likelihood stays within JAX's HEALPix
    quadrature tolerance of the pixel likelihood (tests/test_sparse.py)."""
    model, mc, tc, fields = _cut_pair(kind, spin, layout)
    var = np.stack([np.asarray(variance_expansion_state(jnp.asarray(f),
                                                        LMAX))
                    for f in fields])
    inv = np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)
    rng = np.random.default_rng(4)
    s = rng.normal(size=(NCH, model.nfields, model.nstate)) \
        * np.asarray(model.ell_mask())
    q_jax = np.stack([np.asarray(mc.q_apply_cut(jnp.asarray(si),
                                                jnp.asarray(inv)))
                      for si in s])
    _check(tc.q_apply_cut(t64(s), t64(inv)), q_jax, "q_apply_cut",
           rtol=1e-12)
    ll_jax = [float(mc.data_loglike_cut(mc.beam(jnp.asarray(si))))
              for si in s]
    ll = n(tc.data_loglike_cut(tc.beam(t64(s))))
    np.testing.assert_allclose(ll, ll_jax, rtol=1e-12)
    ll_pix = []
    for si in s:
        resid = model.d - model.forward(jnp.asarray(si))
        ll_pix.append(-0.5 * float(jnp.sum(model.noise.inv_noise
                                           * resid * resid)))
    # the full-grid pixel likelihood through the port's flat-map operators
    resid = tc.d - tc.forward(t64(s))
    mine_pix = -0.5 * (tc.noise.inv_noise * resid * resid).sum(dim=(-2, -1))
    np.testing.assert_allclose(n(mine_pix), ll_pix, rtol=1e-12)
    assert np.all(np.abs(ll - np.asarray(ll_pix))
                  < 3e-2 * np.maximum(1.0, np.abs(ll_pix)))


def test_planckish_healpix_split_counts_at_nside_256():
    """bench.py's planckish HEALPix mask at nside 256 (padded layout):
    f_sky 0.774; the floor over 193 belt rings (415-607) at nphi 1024 =
    2 lmax, 97 of them phased; 1140 hole pixels, 434 on cap rings, in 391
    point rows of width 8 (host-side part of the decomposition only)."""
    lay = healpix_layout(256, "padded")
    geo = lay.geo
    mask = planckish_healpix_mask(256)
    assert abs(mask.mean() - 0.774) < 1e-3
    tau = np.stack([mask, mask])[:, lay.src_of] * lay.valid / 0.04
    rows, idx, w_cut, sparse = healpix_cut_weights(lay, tau, lay.valid)
    w_sp, r_of, phi, flat = sparse
    assert (rows.size, rows.min(), rows.max()) == (193, 415, 607)
    assert idx.shape == (193, 1024) and lay.nb == 2 * 512
    assert int((geo.phi0[rows] != 0).sum()) == 97
    assert np.allclose(w_cut, w_cut[:, :, :1], rtol=0, atol=0)
    on_caps = (r_of < lay.ncap) | (r_of >= lay.ncap + lay.nbelt)
    assert (r_of.size, int(on_caps.sum())) == (1140, 434)
    _, phi_pad, valid, gidx = group_points_by_ring(r_of, geo.theta[r_of],
                                                   phi, flat)
    assert phi_pad.shape == (391, 8) and int(valid.sum()) == 1140
    assert (w_sp[:, gidx[valid > 0]] > 0).any(axis=0).all()


# ---------------------------------------------------------------------------
# CR steps
# ---------------------------------------------------------------------------

def _var(fields, nch, rng):
    var = np.stack([np.asarray(variance_expansion_state(jnp.asarray(f),
                                                        LMAX))
                    for f in fields])
    return var[None] * np.exp(0.2 * rng.normal(size=(nch, 1, 1)))


@pytest.mark.parametrize("layout", ["padded", "ring"])
def test_cr_steps_match_jax_on_split_model(holey, layout):
    """aux_gibbs_cr, mala_cr and aux_then_mala_cr per chain on the split
    HEALPix model (cap holes in the point set), fed the same pools and
    MALA uniforms: states, accepts and CRInfo.extra equal JAX's."""
    _, mc, tc, fields = holey(2, layout)
    rng = np.random.default_rng(3)
    var = _var(fields, NCH, rng)
    s_old = np.sqrt(var) * rng.normal(size=var.shape)
    pool = {"state": rng.normal(size=(NCH, 2, mc.nfields, mc.nstate)),
            "aux": rng.normal(size=(NCH, 1) + tuple(mc.w_cut.shape)),
            "sp": rng.normal(size=(NCH, 1) + tuple(mc.w_sp.shape))}
    bt = mc.bt_ninv_d()
    _check(tc.bt_ninv_d(), bt, "bt_ninv_d")
    keys = jax.random.split(jax.random.PRNGKey(4), NCH)
    tpool = {k: t64(v) for k, v in pool.items()}
    jpool = [{k: jnp.asarray(v[c]) for k, v in pool.items()}
             for c in range(NCH)]
    args = lambda c: (mc, jnp.asarray(var[c]), bt, jnp.asarray(s_old[c]))
    ref = [jax_aux_gibbs(keys[c], *args(c), n_gibbs=1, noise=jpool[c])[0]
           for c in range(NCH)]
    mine, _ = aux_gibbs_cr(tc, t64(var), tc.bt_ninv_d(), t64(s_old),
                           noise=tpool)
    _check(mine, np.stack(ref), "aux_gibbs_cr")
    u = t64([float(jax.random.uniform(jax.random.split(k)[1],
                                      dtype=jnp.float64)) for k in keys])
    ref = [jax_mala(keys[c], *args(c), tau=0.02, noise=jpool[c])
           for c in range(NCH)]
    mine, info = mala_cr(tc, t64(var), tc.bt_ninv_d(), t64(s_old), tau=0.02,
                         noise=tpool, u=u)
    _check(mine, np.stack([r[0] for r in ref]), "mala_cr")
    _check(info.extra, [float(r[1].extra) for r in ref], "mala extra")
    u = t64([float(jax.random.uniform(jax.random.split(
        jax.random.split(k)[1])[1], dtype=jnp.float64)) for k in keys])
    ref = [jax_aux_mala(keys[c], *args(c), n_gibbs=1, tau=0.02,
                        noise=jpool[c]) for c in range(NCH)]
    mine, info = aux_then_mala_cr(tc, t64(var), tc.bt_ninv_d(), t64(s_old),
                                  n_gibbs=1, tau=0.02, noise=tpool, u=u)
    _check(mine, np.stack([r[0] for r in ref]), "aux_then_mala_cr")
    np.testing.assert_array_equal(n(info.accept),
                                  [float(r[1].accept) for r in ref])


def test_full_grid_cr_steps_match_jax(holey):
    """The full-grid (no cut) aux step and MALA step on the flat padded
    HEALPix maps: the gap (mu - N^-1) is 0 on padding, the aux pool has
    the noise's (nfields, npadded) shape, and both steps equal JAX's."""
    model, _, _, fields = holey(2, "padded")
    tm = port_model(model)
    assert tm.map_ndim == 1 and tm.noise.pix_ndim == 1
    rng = np.random.default_rng(5)
    var = _var(fields, NCH, rng)
    s_old = np.sqrt(var) * rng.normal(size=var.shape)
    pool = {"state": rng.normal(size=(NCH, 2, 2, model.nstate)),
            "aux": rng.normal(size=(NCH, 1) + tuple(model.noise.tau.shape))}
    bt = model.bt_ninv_d()
    _check(tm.bt_ninv_d(), bt, "bt_ninv_d", rtol=1e-12)
    keys = jax.random.split(jax.random.PRNGKey(6), NCH)
    jpool = [{k: jnp.asarray(v[c]) for k, v in pool.items()}
             for c in range(NCH)]
    ref = [jax_aux_gibbs(keys[c], model, jnp.asarray(var[c]), bt,
                         jnp.asarray(s_old[c]), n_gibbs=1,
                         noise=jpool[c])[0] for c in range(NCH)]
    mine, _ = aux_gibbs_cr(tm, t64(var), tm.bt_ninv_d(), t64(s_old),
                           noise={k: t64(v) for k, v in pool.items()})
    _check(mine, np.stack(ref), "full-grid aux_gibbs_cr")
    u = t64([float(jax.random.uniform(jax.random.split(k)[1],
                                      dtype=jnp.float64)) for k in keys])
    ref = [jax_mala(keys[c], model, jnp.asarray(var[c]), bt,
                    jnp.asarray(s_old[c]), tau=0.02, noise=jpool[c])
           for c in range(NCH)]
    mine, info = mala_cr(tm, t64(var), tm.bt_ninv_d(), t64(s_old), tau=0.02,
                         noise={k: t64(v) for k, v in pool.items()}, u=u)
    _check(mine, np.stack([r[0] for r in ref]), "full-grid mala_cr")
    _check(info.extra, [float(r[1].extra) for r in ref], "mala extra")


# ---------------------------------------------------------------------------
# The table engine's ring-phase and Nyquist paths
# ---------------------------------------------------------------------------

def _mh_setup(fields, lmax=LMAX, big=7):
    """Unit bins; the first fields one block, the last a ``big``-bin block
    plus single-bin blocks."""
    nf = len(fields)
    bins = [np.arange(2, lmax + 2)] * nf
    nb = lmax - 1
    blocks = ([[(0, nb)]] * (nf - 1)
              + [[(0, big)] + [(i, i + 1) for i in range(big, nb)]])
    dl0 = [np.maximum(f[2:], 1e-3) for f in fields]
    return bins, blocks, [0.5 * d for d in dl0], dl0


def _mh_inputs(mc, bins, blocks, dl0, n_iter, seed):
    rng = np.random.default_rng(seed)
    dls = [d * np.exp(0.2 * rng.normal(size=(NCH, len(d)))) for d in dl0]
    s_nc = valid_normal(rng, (NCH, mc.nfields, mc.nstate), mc.lmax)
    keys = jax.random.split(jax.random.PRNGKey(seed), NCH)
    ntot = sum(len(b) - 1 for b in bins)
    nblocks = sum(map(len, blocks))
    uni = [jax_mh_uniforms(k, n_iter, ntot, nblocks) for k in keys]
    return (keys, dls, s_nc, t64(np.stack([u[0] for u in uni])),
            t64(np.stack([u[1] for u in uni])))


def _table_vs_jax_and_direct(mc, tc, fields, seed):
    bins, blocks, sig, dl0 = _mh_setup(fields, mc.lmax)
    keys, dls, s_nc, up, ua = _mh_inputs(mc, bins, blocks, dl0, 2, seed)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
        k, d, s, mc, bins, blocks, sig, n_iter=2)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    plan = tcs.CutMHPlan(tc, bins, blocks, sig, dtype=torch.float64)
    assert len(plan.chunks) >= 2
    dlt = tuple(t64(d) for d in dls)
    fast = tcs.nc_cls_sample_cut(dlt, t64(s_nc), tc, bins, blocks, sig,
                                 n_iter=2, u_prop=up, u_acc=ua, plan=plan)
    direct = tcs.nc_cls_sample(dlt, t64(s_nc), tcs.make_nc_log_likelihood(
        tc, bins), bins, blocks, sig, n_iter=2, u_prop=up, u_acc=ua)
    for f in range(len(bins)):
        _check(fast[0][f], ref[0][f], f"dl[{f}] vs JAX")
        _check(fast[0][f], n(direct[0][f]), f"dl[{f}] vs direct")
        np.testing.assert_array_equal(n(fast[1].accept[f]),
                                      np.asarray(ref[1].accept[f]))
        np.testing.assert_array_equal(n(fast[1].accept[f]),
                                      n(direct[1].accept[f]))
    _check(fast[1].log_like, ref[1].log_like, "log_like vs JAX")
    _check(fast[1].log_like, n(direct[1].log_like), "log_like vs direct")
    acc = np.concatenate([n(a).ravel() for a in fast[1].accept])
    assert 0.0 < acc.mean() < 1.0
    return plan


@pytest.mark.parametrize("kind,spin", [("band", 0), ("band", 2),
                                       ("holey", 2)])
def test_nyquist_table_engine_matches_jax_and_direct(monkeypatch, kind,
                                                     spin):
    """nc_cls_sample_cut on HEALPix cut rows (nphi = 2 lmax, phased and
    unphased rows mixed; with cap holes in the point set for "holey") over
    2 sweeps, chunks of at most 3 bins: equal to JAX's table engine on the
    same keys and to the port's direct nc_cls_sample on the same
    uniforms."""
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    _, mc, tc, fields = _cut_pair(kind, spin, "padded")
    phi0 = tc.cut_sht.grid.phi0
    assert (phi0 != 0).any() and (phi0 == 0).any()
    plan = _table_vs_jax_and_direct(mc, tc, fields, 11)
    assert plan.ph_c is not None
    assert all(c.lnyq is not None for c in plan.chunks)
    for c in plan.chunks:
        assert not n(c.lamA[LMAX]).any()


# ---------------------------------------------------------------------------
# The scheme
# ---------------------------------------------------------------------------

def test_asis_steps_match_jax_on_holey_healpix(holey, monkeypatch):
    """Three ASISGibbs iterations of NCH chains on the split padded HEALPix
    model: the JAX scheme's vmapped step and the port's batched step, fed
    the same pools, MALA uniforms, gamma variates and MH uniforms, agree at
    every iteration; the CR and MH accepts are equal."""
    _, mc, tc, fields = holey(2, "padded")
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    bins, blocks, _, dl0 = _mh_setup(fields)
    sig = [0.3 * d for d in dl0]
    kw = dict(n_iter_mh=1, cr_method="aux_mala", cr_options=OPTS)
    jsch = JaxASIS(mc, bins, blocks, sig, **kw)
    tsch = ASISGibbs(tc, bins, blocks, sig, **kw)
    assert jsch._use_cut_mh and tsch._use_cut_mh
    jstep = jax.jit(jax.vmap(jsch.step))
    dls = tuple(np.tile(d, (NCH, 1)) for d in dl0)
    var = np.asarray(jax.vmap(jsch.var_cls)(tuple(jnp.asarray(d)
                                                  for d in dls)))
    s0 = np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(jnp.asarray(d)
                                                  for d in dls))
    tstate = state_from_numpy(s0, dls, device="cpu")
    ell = jnp.arange(LMAX + 1, dtype=jnp.float64)
    alphas = [jnp.where(a <= 0, 1.0, a) for a in
              (jax_bin_sum(2.0 * ell + 1.0, b, LMAX) / 2.0 - 1.0
               for b in bins)]
    ntot = sum(len(b) - 1 for b in bins)
    nblocks = sum(map(len, blocks))
    rng = np.random.default_rng(1)
    mh_acc = []
    for it in range(3):
        pool = {"state": rng.normal(size=(NCH, 2, 2, tc.nstate)),
                "aux": rng.normal(size=(NCH, 1) + tuple(tc.w_cut.shape)),
                "sp": rng.normal(size=(NCH, 1) + tuple(tc.w_sp.shape))}
        keys = jax.random.split(jax.random.PRNGKey(200 + it), NCH)
        jstate, jinfo = jstep(keys, jstate,
                              {k: jnp.asarray(v) for k, v in pool.items()})
        u, gam, up, ua = [], [[], []], [], []
        for key in keys:
            k1, k2, k3 = jax.random.split(key, 3)
            ka = jax.random.split(jax.random.split(k1)[1])[1]
            u.append(float(jax.random.uniform(ka, dtype=jnp.float64)))
            for f, kf in enumerate(jax.random.split(k2, 2)):
                gam[f].append(np.asarray(jax.random.gamma(kf, alphas[f])))
            p_, a_ = jax_mh_uniforms(k3, 1, ntot, nblocks)
            up.append(p_)
            ua.append(a_)
        tstate, tinfo = tsch.step(
            tstate, noise={k: t64(v) for k, v in pool.items()}, u=t64(u),
            gammas=tuple(t64(g) for g in gam), u_prop=t64(up), u_acc=t64(ua))
        for what, mine, ref in [("s", tstate.s, jstate.s),
                                ("dl[0]", tstate.dl[0], jstate.dl[0]),
                                ("dl[1]", tstate.dl[1], jstate.dl[1])]:
            _check(mine, ref, f"iteration {it} {what}")
        np.testing.assert_array_equal(n(tinfo["cr_accept"]),
                                      np.asarray(jinfo["cr_accept"]))
        for f in range(2):
            np.testing.assert_array_equal(n(tinfo["mh_accept"][f]),
                                          np.asarray(jinfo["mh_accept"][f]))
            mh_acc.append(n(tinfo["mh_accept"][f]).ravel())
    assert 0.0 < np.concatenate(mh_acc).mean() < 1.0

