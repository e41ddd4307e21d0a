"""The port's non-centered and PNCP schemes against the JAX package
(float64, CPU): the pixel and harmonic ("all_sph") likelihoods with their
exact log-ratios, the table engine's identity re-centering below l_cut
(``CutMHPlan(l_cut_identity=...)``), ``NonCenteredGibbs`` steps on the
table engine, the direct path and all_sph, ``PNCPGibbs`` steps on the
table engine (per-field l_cut, EE fully centered) and on the direct path;
statistical mirrors of tests/test_schemes.py; and bench.py's PNCP bins
and blocks at lmax 512 (``flagship.pncp_bins_blocks``).

The uniforms and gamma variates are recomputed here from the
``jax.random.split``s that the JAX schemes make, and handed to the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_mh_uniforms, jax_model_arrays, make_masked, n,
                          port_model, t64, valid_normal)
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.inference import example_dl, simulate_dataset
from gibbssampler_tpu.samplers import cls_samplers as jcs
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu.schemes import NonCenteredGibbs as JaxNC
from gibbssampler_tpu.schemes import PNCPGibbs as JaxPNCP
from gibbssampler_tpu_torch import flagship
from gibbssampler_tpu_torch.harmonics import alm2cl_state, dl_to_cl_factor
from gibbssampler_tpu_torch.interop import model_from_numpy, state_from_numpy
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.schemes import (CenteredGibbs, NonCenteredGibbs,
                                            PNCPGibbs)

LMAX = 10
NCH = 3
RTOL = 1e-9
# pixel noise variance: at lmax 10 the spectrum of example_dl is ~1e-4, so
# a variance of 1e-4 puts the noise level near the signal and the MH
# accepts below 1
SIGMA2 = 1e-4
BINS = np.array([2, 3, 4, 6, 8, 11])
OPTS = {"n_gibbs": 1, "tau": 0.02}


def _check(mine, ref, what, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(mine), ref, rtol=rtol,
                               atol=rtol * max(1e-300, float(np.abs(ref).max())),
                               err_msg=what)


def _binned(f, bins=BINS):
    return np.array([f[lo:hi].mean() for lo, hi in zip(bins[:-1], bins[1:])])


@pytest.fixture(scope="module")
def band():
    """(JAX cut model, port cut model, fields): band-masked E/B sky."""
    _, mc, fields = make_masked(spin=2, sigma2=SIGMA2)
    return mc, port_model(mc, cut=True), fields


@pytest.fixture(scope="module")
def full_grid():
    """The same band-masked sky without the cut decomposition."""
    jm, _, fields = make_masked(spin=2, sigma2=SIGMA2)
    return jm, port_model(jm), fields


@pytest.fixture(scope="module")
def full_sky():
    """A full-sky E/B sky, with the data's alm (the all_sph likelihood)."""
    fields = np.stack([example_dl(LMAX, "ee", amp=10.0),
                       example_dl(LMAX, "bb", amp=10.0)])
    jm, _ = simulate_dataset(jax.random.PRNGKey(3), LMAX, spin=2,
                             dl_fields=fields, noise_sigma2=SIGMA2,
                             fwhm_radians=0.05, dtype=jnp.float64)
    tm = model_from_numpy(jax_model_arrays(jm), device="cpu")
    jd = jnp.stack(jm.sht.analysis_spin2_state(jm.d[0], jm.d[1]))
    td = torch.stack(tm.sht.analysis_spin2_state(tm.d[0], tm.d[1]))
    _check(td, jd, "d_alm")
    return jm, tm, fields, jd, td


def _mala_uniform(key):
    """The MALA accept uniform of aux_then_mala_cr(key)."""
    _, k2 = jax.random.split(key)
    return float(jax.random.uniform(jax.random.split(k2)[1],
                                    dtype=jnp.float64))


def _gammas(key, nfields=2):
    """The gamma variates centered_cls_sample(key) draws, per field."""
    ell = jnp.arange(LMAX + 1, dtype=jnp.float64)
    alpha = jax_bin_sum(2.0 * ell + 1.0, BINS, LMAX) / 2.0 - 1.0
    alpha = jnp.where(alpha <= 0, 1.0, alpha)
    return [np.asarray(jax.random.gamma(kf, alpha))
            for kf in jax.random.split(key, nfields)]


def _run_steps(jsch, tsch, jm, fields, nsteps, cr, kind, seed):
    """``nsteps`` iterations of JAX's vmapped step and the port's batched
    step on the same pools and variates ("nc": keys k1 CR, k2 MH; "pncp":
    k1 CR, k2 gammas, k3 MH); every state, D_ell and accept compared."""
    jstep = jax.jit(jax.vmap(jsch.step))
    dl0 = [_binned(f) for f in fields]
    dls = tuple(np.tile(d, (NCH, 1)) for d in dl0)
    var = np.asarray(jax.vmap(jsch.var_cls)(tuple(jnp.asarray(d)
                                                  for d in dls)))
    rng = np.random.default_rng(seed)
    s0 = np.sqrt(var) * rng.normal(size=var.shape)
    if kind == "nc":
        s0 = s0 / np.sqrt(np.where(var > 0, var, 1.0))
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(jnp.asarray(d)
                                                  for d in dls))
    tstate = state_from_numpy(s0, dls, device="cpu")
    ntot = 2 * (len(BINS) - 1)
    nblocks = sum(map(len, tsch.blocks_list))
    assert sum(map(len, jsch.blocks_list)) == nblocks
    accepted = []
    for it in range(nsteps):
        pool = {"state": rng.normal(size=(NCH, 2, 2, jm.nstate))}
        if cr == "aux_mala":
            aux = jm.w_cut.shape if jm.has_cut else jm.noise.tau.shape
            pool["aux"] = rng.normal(size=(NCH, 1) + tuple(aux))
        keys = jax.random.split(jax.random.PRNGKey(100 * seed + it), NCH)
        jstate, jinfo = jstep(keys, jstate,
                              {k: jnp.asarray(v) for k, v in pool.items()})
        kw = {"noise": {k: t64(v) for k, v in pool.items()}}
        u, gam, up, ua = [], [[], []], [], []
        for key in keys:
            ks = jax.random.split(key, 2 if kind == "nc" else 3)
            if cr == "aux_mala":
                u.append(_mala_uniform(ks[0]))
            if kind == "pncp":
                for f, g in enumerate(_gammas(ks[1])):
                    gam[f].append(g)
            p_, a_ = jax_mh_uniforms(ks[-1], 1, ntot, nblocks)
            up.append(p_)
            ua.append(a_)
        if u:
            kw["u"] = t64(u)
        if kind == "pncp":
            kw["gammas"] = tuple(t64(g) for g in gam)
        tstate, tinfo = tsch.step(tstate, u_prop=t64(up), u_acc=t64(ua),
                                  **kw)
        _check(tstate.s, jstate.s, f"iteration {it} s")
        for f in range(2):
            _check(tstate.dl[f], jstate.dl[f], f"iteration {it} dl[{f}]")
            np.testing.assert_array_equal(n(tinfo["mh_accept"][f]),
                                          np.asarray(jinfo["mh_accept"][f]))
            accepted.append(n(tinfo["mh_accept"][f]).ravel())
    acc = np.concatenate(accepted)
    assert 0.0 < acc.mean() < 1.0
    return tsch


# ---------------------------------------------------------------------------
# likelihoods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pix", "sph"])
def test_log_likelihoods_match_jax(request, kind):
    """make_nc_log_likelihood on a full-grid masked model (pixel form) and
    with all_sph on the full sky (harmonic form): the totals against JAX's,
    and ``delta`` (one synthesis of the move, formed term by term) equal
    to the difference of the totals, per chain."""
    if kind == "pix":
        jm, tm, fields = request.getfixturevalue("full_grid")
        jd = td = None
    else:
        jm, tm, fields, jd, td = request.getfixturevalue("full_sky")
    bins = [BINS, BINS]
    ll_j = jcs.make_nc_log_likelihood(jm, bins, all_sph=kind == "sph",
                                      d_alm=jd)
    ll_t = tcs.make_nc_log_likelihood(tm, bins, all_sph=kind == "sph",
                                      d_alm=td)
    assert ll_t.kind == kind
    rng = np.random.default_rng(1)
    dl0 = [_binned(f) for f in fields]
    dls = [tuple(d * np.exp(0.2 * rng.normal(size=(NCH, len(d))))
                 for d in dl0) for _ in range(2)]
    s_nc = valid_normal(rng, (NCH, 2, tm.nstate), LMAX)
    ref = [np.asarray(jax.vmap(lambda d, s: ll_j(d, s))(
        tuple(jnp.asarray(x) for x in dl), jnp.asarray(s_nc))) for dl in dls]
    tot0, carry = ll_t.at(tuple(t64(x) for x in dls[0]), t64(s_nc))
    _check(tot0, ref[0], "total")
    _check(ll_t(tuple(t64(x) for x in dls[1]), t64(s_nc)), ref[1], "call")
    dll, _ = ll_t.delta(carry, tuple(t64(x) for x in dls[0]),
                        tuple(t64(x) for x in dls[1]), t64(s_nc))
    np.testing.assert_allclose(n(dll), ref[1] - ref[0],
                               atol=1e-9 * np.abs(ref[0]).max())
    with pytest.raises(ValueError):
        tcs.make_nc_log_likelihood(tm, bins, all_sph=True)


# ---------------------------------------------------------------------------
# the table engine with the identity re-centering
# ---------------------------------------------------------------------------

LCUT_CASES = {"scalar": 6, "tuple": (4, 6), "ndarray": np.array([4, 6])}


@pytest.mark.parametrize("case", sorted(LCUT_CASES))
def test_table_engine_identity_recentering_matches_jax(band, case):
    """nc_cls_sample_cut with l_cut_identity against JAX's on the same keys
    over two sweeps: EE one block above its cut, BB single-bin blocks above
    its own.  A numpy array is taken per field; JAX's takes its scalar
    branch there (gibbssampler_tpu/samplers/cls_samplers.py:596), so JAX
    runs with the same values as a tuple."""
    mc, tc, fields = band
    lc = LCUT_CASES[case]
    lcs = (lc,) * 2 if np.ndim(lc) == 0 else tuple(int(c) for c in lc)
    cbs = [int(np.searchsorted(BINS, c)) for c in lcs]
    bins = [BINS, BINS]
    blocks = [[(cbs[0], 5)], [(i, i + 1) for i in range(cbs[1], 5)]]
    sig = [0.3 * _binned(f) for f in fields]
    rng = np.random.default_rng(4)
    dls = [_binned(f) * np.exp(0.2 * rng.normal(size=(NCH, 5)))
           for f in fields]
    s_nc = valid_normal(rng, (NCH, 2, tc.nstate), LMAX)
    keys = jax.random.split(jax.random.PRNGKey(4), NCH)
    nblocks = sum(map(len, blocks))
    uni = [jax_mh_uniforms(k, 2, 10, nblocks) for k in keys]
    jlc = lcs if case == "ndarray" else lc
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
        k, d, s, mc, bins, blocks, sig, n_iter=2, l_cut_identity=jlc)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    plan = tcs.CutMHPlan(tc, bins, blocks, sig, l_cut_identity=lc,
                         dtype=torch.float64)
    low = n(plan.lowm).reshape(2, 2, LMAX + 1, LMAX + 1)
    for f, c in enumerate(lcs):
        assert low[f, 0, 0, :c].all() and not low[f, ..., c:].any()
    dl, info = tcs.nc_cls_sample_cut(
        tuple(t64(d) for d in dls), t64(s_nc), tc, bins, blocks, sig,
        n_iter=2, u_prop=t64(np.stack([u[0] for u in uni])),
        u_acc=t64(np.stack([u[1] for u in uni])), plan=plan)
    for f in range(2):
        _check(dl[f], ref[0][f], f"dl[{f}]")
        np.testing.assert_array_equal(n(info.accept[f]),
                                      np.asarray(ref[1].accept[f]))
    _check(info.log_like, ref[1].log_like, "log_like")


def test_table_engine_without_big_blocks_matches_direct(band):
    """EE fully centered (no block) and BB single-bin blocks only, the
    PNCP shape of bench.py: the plan has no big block, its u0 carries all
    of EE through u_base, and the table engine equals the direct path on
    the PNCP likelihood (prior variance 1 below l_cut) on the same
    uniforms."""
    _, tc, fields = band
    sch = PNCPGibbs(tc, [BINS, BINS], [[], [(i, i + 1) for i in range(5)]],
                    [0.3 * _binned(f) for f in fields], l_cut=(11, 4),
                    cr_method="aux_mala", cr_options=OPTS)
    assert sch._use_cut_mh and sch.mh_plan.big_rows == []
    assert sch.blocks_list == ((), ((2, 3), (3, 4), (4, 5)))
    rng = np.random.default_rng(5)
    dls = tuple(t64(_binned(f) * np.exp(0.2 * rng.normal(size=(NCH, 5))))
                for f in fields)
    s_nc = t64(valid_normal(rng, (NCH, 2, tc.nstate), LMAX))
    up = t64(rng.uniform(size=(NCH, 3, 10)))
    ua = t64(rng.uniform(size=(NCH, 3, 3)))
    kw = dict(u_prop=up, u_acc=ua)
    fast = tcs.nc_cls_sample_cut(dls, s_nc, tc, sch.bins_list,
                                 sch.blocks_list, sch.prop_sigma_list,
                                 n_iter=3, plan=sch.mh_plan, **kw)
    direct = tcs.nc_cls_sample(dls, s_nc, sch.log_like, sch.bins_list,
                               sch.blocks_list, sch.prop_sigma_list,
                               n_iter=3, **kw)
    for f in range(2):
        _check(fast[0][f], n(direct[0][f]), f"dl[{f}]")
        np.testing.assert_array_equal(n(fast[1].accept[f]),
                                      n(direct[1].accept[f]))
    _check(fast[1].log_like, n(direct[1].log_like), "log_like")
    assert fast[1].accept[0].shape == (NCH, 0)


# ---------------------------------------------------------------------------
# NonCenteredGibbs and PNCPGibbs steps against JAX
# ---------------------------------------------------------------------------

NC_BLOCKS = [[(0, 5)], [(0, 2)] + [(i, i + 1) for i in range(2, 5)]]


@pytest.mark.parametrize("path", ["table", "direct", "all_sph"])
def test_noncentered_steps_match_jax(request, monkeypatch, path):
    """Three NonCenteredGibbs iterations (recenter -> CR -> whiten ->
    blocked MH; state s_nc) against JAX's vmapped step: on the table
    engine and the direct path (mh_fast "off") of the band cut model with
    the aux_mala CR, and with all_sph on the full sky with the exact CR."""
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 2)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 2)
    if path == "all_sph":
        jm, tm, fields, jd, td = request.getfixturevalue("full_sky")
        kw = dict(cr_method="exact", all_sph=True)
        jkw, tkw = dict(d_alm=jd), dict(d_alm=td)
        cr = "exact"
    else:
        jm, tm, fields = request.getfixturevalue("band")
        kw = dict(cr_method="aux_mala", cr_options=OPTS,
                  mh_fast="off" if path == "direct" else "auto")
        jkw = tkw = {}
        cr = "aux_mala"
    sig = [0.3 * _binned(f) for f in fields]
    jsch = JaxNC(jm, [BINS, BINS], NC_BLOCKS, sig, **kw, **jkw)
    tsch = NonCenteredGibbs(tm, [BINS, BINS], NC_BLOCKS, sig, **kw, **tkw)
    assert tsch._use_cut_mh == jsch._use_cut_mh == (path == "table")
    _run_steps(jsch, tsch, jm, fields, 3, cr, "nc", 1)


PNCP_CASES = {
    "table": ("band", (4, 6), "auto"),
    "table ndarray l_cut": ("band", np.array([4, 6]), "auto"),
    "table EE centered": ("band", (11, 4), "auto"),
    "direct": ("band", (4, 6), "off"),
    "direct full grid": ("full_grid", (4, 6), "auto"),
}


@pytest.mark.parametrize("case", sorted(PNCP_CASES))
def test_pncp_steps_match_jax(request, monkeypatch, case):
    """Three PNCPGibbs iterations against JAX's vmapped step: per-field
    l_cut (EE 4 and BB 6, given as a tuple or an ndarray; or EE fully
    centered and BB from 4), blocks below each cut dropped; the table
    engine with the identity re-centering, the direct path on the cut
    model (mh_fast "off") and on a full-grid model (MALA CR)."""
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 2)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 2)
    sky, l_cut, mh_fast = PNCP_CASES[case]
    jm, tm, fields = request.getfixturevalue(sky)
    cr = "aux_mala" if jm.has_cut else "mala"
    blocks = [[(0, 2), (2, 5)], [(0, 2)] + [(i, i + 1) for i in range(2, 5)]]
    sig = [0.3 * _binned(f) for f in fields]
    kw = dict(cr_method=cr, cr_options=OPTS, mh_fast=mh_fast)
    jsch = JaxPNCP(jm, [BINS, BINS], blocks, sig, l_cut=tuple(
        int(c) for c in l_cut), **kw)
    tsch = PNCPGibbs(tm, [BINS, BINS], blocks, sig, l_cut=l_cut, **kw)
    assert tsch.cut_bin == jsch.cut_bin and tsch.l_cut == jsch.l_cut
    assert tsch.blocks_list == jsch.blocks_list
    assert tsch._use_cut_mh == jsch._use_cut_mh == case.startswith("table")
    _run_steps(jsch, tsch, jm, fields, 3, cr, "pncp", 2)


def test_pncp_rejects_bad_lcut(band):
    """Mirrors tests/test_schemes.py::test_pncp_rejects_bad_lcut: an l_cut
    that is no bin boundary, or one per field of the wrong count, raises
    ValueError; mh_fast "phi" pins the fast path's phi-domain engine."""
    _, tc, fields = band
    sig = [np.ones(5)] * 2
    for bad in (LMAX + 5, 5, (4, 6, 8)):
        with pytest.raises(ValueError):
            PNCPGibbs(tc, [BINS, BINS], [[(0, 3)], [(0, 3)]], sig, l_cut=bad)
    phi = PNCPGibbs(tc, [BINS, BINS], [[(0, 3)], [(3, 4), (4, 5)]], sig,
                    l_cut=4, mh_fast="phi")
    assert phi._use_cut_mh and phi.mh_plan.engine == "phi"


# ---------------------------------------------------------------------------
# statistical mirrors of tests/test_schemes.py
# ---------------------------------------------------------------------------

SLMAX = 12


@pytest.fixture(scope="module")
def noisy():
    """tests/test_schemes.py::dataset_noisy on the port: a full-sky T map at
    SNR ~ 1, and the non-centered setup (_nc_setup): unit bins, blocks of
    two bins, Fisher-width proposal scales, the data's alm."""
    dl = example_dl(SLMAX, amp=10.0)
    jm, _ = simulate_dataset(jax.random.PRNGKey(43), SLMAX, spin=0,
                             dl_fields=dl[None], noise_sigma2=50.0,
                             fwhm_radians=0.0, dtype=jnp.float64)
    tm = model_from_numpy(jax_model_arrays(jm), device="cpu")
    bins = np.arange(2, SLMAX + 2)
    nbins = len(bins) - 1
    blocks = [(i, min(i + 2, nbins)) for i in range(0, nbins, 2)]
    d_alm = tm.sht.analysis_state(tm.d[0])[None]
    shat = n(alm2cl_state(d_alm[0], SLMAX))
    noise_h = 1.0 / float(tm.noise.harmonic_white_level()[0])
    fac = n(dl_to_cl_factor(SLMAX, torch.float64))
    ell = np.arange(2, SLMAX + 1)
    cl_hat = np.maximum(shat[2:] - noise_h, 0.3 * shat[2:])
    sig = (2.0 * (cl_hat / fac[2:]) * np.sqrt(noise_h / cl_hat)
           / np.sqrt(2 * ell + 1.0)) * 1.2
    return tm, dl, bins, blocks, sig, d_alm


def _mean_se(chain, burn=0.25):
    c = chain[:, int(burn * chain.shape[1]):, :]
    per_chain = c.mean(axis=1)
    return per_chain.mean(axis=0), per_chain.std(axis=0, ddof=1) / np.sqrt(
        chain.shape[0])


def _centered_chain(tm, dl, bins, seed):
    cen = CenteredGibbs(tm, [bins], cr_method="exact")
    out = cen.run((dl[2:],), n_iter=600, nchains=32,
                  gen=torch.Generator().manual_seed(seed))
    return n(out["dl_chains"][0])


def test_noncentered_allsph_matches_centered(noisy):
    """Mirrors ::test_noncentered_allsph_matches_centered: the all_sph
    non-centered chain (2 MH sweeps per iteration) and the centered chain
    have the same posterior means (6 sigma + 2%); the MH acceptance is not
    degenerate."""
    tm, dl, bins, blocks, sig, d_alm = noisy
    m_c, se_c = _mean_se(_centered_chain(tm, dl, bins, 1))
    nc = NonCenteredGibbs(tm, [bins], [blocks], [sig], n_iter_mh=2,
                          all_sph=True, d_alm=d_alm, cr_method="exact")
    out = nc.run((dl[2:],), n_iter=1200, nchains=32,
                 gen=torch.Generator().manual_seed(2))
    acc = n(out["mh_accept"][0]).mean()
    assert 0.05 < acc < 0.95, acc
    m_n, se_n = _mean_se(n(out["dl_chains"][0]))
    tol = 6 * np.sqrt(se_c ** 2 + se_n ** 2) + 0.02 * m_c
    assert np.all(np.abs(m_c - m_n) < tol), (m_c - m_n) / tol


def test_pncp_matches_centered(noisy):
    """Mirrors ::test_pncp_matches_centered: PNCP with l_cut 7 (the block
    below the cut dropped, one block above it, the direct pixel path of the
    full-sky model) and the centered chain agree (6 sigma + 3%)."""
    tm, dl, bins, _, sig, _ = noisy
    m_c, se_c = _mean_se(_centered_chain(tm, dl, bins, 5))
    nbins = len(bins) - 1
    cut_bin = 7 - 2
    pncp = PNCPGibbs(tm, [bins], [[(0, cut_bin), (cut_bin, nbins)]], [sig],
                     l_cut=7, n_iter_mh=2, cr_method="exact")
    assert pncp.blocks_list == (((cut_bin, nbins),),)
    assert not pncp._use_cut_mh
    out = pncp.run((dl[2:],), n_iter=600, nchains=32,
                   gen=torch.Generator().manual_seed(6))
    m_p, se_p = _mean_se(n(out["dl_chains"][0]))
    tol = 6 * np.sqrt(se_c ** 2 + se_p ** 2) + 0.03 * m_c
    assert np.all(np.abs(m_p - m_c) < tol), (m_p - m_c) / tol


# ---------------------------------------------------------------------------
# bench.py's PNCP configuration
# ---------------------------------------------------------------------------

def test_flagship_pncp_bins_and_blocks_follow_bench():
    """flagship.pncp_bins_blocks at lmax 512 with bench.py's default
    BENCH_LCUT "none,300" (bench.py:324-336): the ASIS bins, l_cut [513,
    300], no EE block, BB singles from bin 298 (l = 300) to 409; an EE cut
    at 200 gives one joint EE block; a cut inside a bin raises."""
    bins, lc, blocks = flagship.pncp_bins_blocks(512)
    abins, _ = flagship.asis_bins_blocks(512)
    for a, b in zip(bins, abins):
        np.testing.assert_array_equal(a, b)
    assert lc == [513, 300]
    assert blocks[0] == []
    assert blocks[1] == [(i, i + 1) for i in range(298, 410)]
    assert bins[1][298] == 300
    _, lc, blocks = flagship.pncp_bins_blocks(512, (200, 300))
    assert lc == [200, 300] and blocks[0] == [(198, 511)]
    with pytest.raises(ValueError):
        flagship.pncp_bins_blocks(512, ("none", 397))
