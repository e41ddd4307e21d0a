"""The port's non-centered blocked-MH D_ell step against the JAX package
(float64, CPU): the truncated-normal proposal, whiten / recenter, the
direct ``nc_cls_sample`` and the table-domain ``nc_cls_sample_cut`` on the
same uniforms (also on phased cut rows and at the Nyquist column), the fast
path against the port's own direct path, the coefficient and phi-domain
engines on the configurations that pick them, and the proposal-scale
helpers.

The uniforms are recomputed here from the ``jax.random.split``s the JAX
samplers make (``torch_parity.jax_mh_uniforms``) and handed to the port.
"""

import dataclasses
import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_mh_uniforms, make_masked, n, port_model, t64,
                          valid_normal)
from gibbssampler_tpu.parallel import adapt as jax_adapt
from gibbssampler_tpu.samplers import cls_samplers as jcs
from gibbssampler_tpu_torch.interop import tuned_proposal_sigmas
from gibbssampler_tpu_torch.parallel import (analytic_proposal_sigma,
                                             block_widths)
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.schemes import ASISGibbs
from gibbssampler_tpu_torch.sht import SHT

LMAX = 12
NCH = 3
RTOL = 1e-9
ROOT = pathlib.Path(__file__).resolve().parent.parent

# BB binnings of the main path's shape at lmax 12: unit bins, and unit bins
# followed by wide ones (2-ell bins among the singles, so ``seg`` is used)
BB_BINS = {"unit": np.arange(2, LMAX + 2),
           "wide": np.array([2, 3, 4, 5, 6, 7, 8, 10, 11, 13])}


def _binned(f, bins):
    return np.array([f[lo:hi].mean() for lo, hi in zip(bins[:-1], bins[1:])])


def _setup(fields, bb_bins, big=3):
    """Bins, blocks (first field one block; last field a ``big``-bin block
    plus single-bin blocks), proposal scales and starting D_ell."""
    ee = np.arange(2, LMAX + 2)
    bins = [ee, bb_bins] if len(fields) == 2 else [bb_bins]
    nbs = [len(b) - 1 for b in bins]
    blocks = [[(0, nb)] for nb in nbs[:-1]]
    blocks.append([(0, big)] + [(i, i + 1) for i in range(big, nbs[-1])])
    dl0 = [np.maximum(_binned(f, b), 1e-6) for f, b in zip(fields, bins)]
    sig = [0.5 * d for d in dl0]
    return bins, blocks, sig, dl0


def _check(mine, ref, what, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(mine), ref, rtol=rtol,
                               atol=rtol * max(1e-300, float(np.abs(ref).max())),
                               err_msg=what)


@pytest.fixture(scope="module")
def pol():
    """(JAX cut model, port cut model, fields): band-masked E/B sky."""
    _, mc, fields = make_masked(spin=2, sigma2=0.5, lmax=LMAX)
    return mc, port_model(mc, cut=True), fields


@pytest.fixture(scope="module")
def temp():
    """The same for a spin-0 (T) sky."""
    _, mc, fields = make_masked(spin=0, sigma2=0.5, lmax=LMAX)
    return mc, port_model(mc, cut=True), fields


def _inputs(mc, bins, blocks, dl0, n_iter, seed):
    """Per-chain keys, scattered starting D_ell, a whitened map and the
    JAX uniforms of each chain's key."""
    rng = np.random.default_rng(seed)
    dls = [d * np.exp(0.2 * rng.normal(size=(NCH, len(d)))) for d in dl0]
    s_nc = valid_normal(rng, (NCH, mc.nfields, mc.nstate), LMAX)
    keys = jax.random.split(jax.random.PRNGKey(seed), NCH)
    ntot = sum(len(b) - 1 for b in bins)
    nblocks = sum(len(b) for b in blocks)
    uni = [jax_mh_uniforms(k, n_iter, ntot, nblocks) for k in keys]
    return (keys, dls, s_nc, t64(np.stack([u[0] for u in uni])),
            t64(np.stack([u[1] for u in uni])))


def test_propose_truncnorm_matches_jax():
    """An injected U = uniform(key, shape) reproduces
    jax.random.truncated_normal(key) to rounding, from x far above zero
    (a = -1) to x far below its scale."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-3, 0.1, 20), rng.uniform(0.5, 50, 20)])
    sigma = np.concatenate([rng.uniform(0.5, 2.0, 20),
                            rng.uniform(1e-2, 1.0, 20)])
    x = np.tile(x, (3, 1))
    key = jax.random.PRNGKey(1)
    u = jax.random.uniform(key, x.shape, dtype=jnp.float64)
    ref = x + sigma * jax.random.truncated_normal(
        key, -x / sigma, jnp.inf, dtype=jnp.float64)
    got = tcs.propose_truncnorm(t64(x), t64(sigma), t64(u))
    _check(got, ref, "propose_truncnorm", rtol=1e-12)
    assert (n(got) > 0).all()


def test_propose_truncnorm_moments_from_generator():
    """Drawn from the generator: the mean of N(x, sigma^2) truncated to
    [0, inf) is x + sigma phi(a) / (1 - Phi(a)), a = -x / sigma."""
    from scipy.stats import norm
    x, sigma = np.array([0.1, 1.0, 3.0]), np.array([1.0, 1.0, 0.5])
    gen = torch.Generator().manual_seed(0)
    draws = n(tcs.propose_truncnorm(t64(np.tile(x, (40000, 1))), t64(sigma),
                                    gen=gen))
    a = -x / sigma
    mean = x + sigma * norm.pdf(a) / norm.sf(a)
    assert (draws >= 0).all()
    np.testing.assert_allclose(draws.mean(0), mean,
                               atol=6 * sigma.max() / np.sqrt(40000))


@pytest.mark.parametrize("bb", sorted(BB_BINS))
def test_logratio_whiten_recenter_match_jax(pol, bb):
    """truncnorm_logratio, whiten and recenter against JAX on every chain,
    and recenter(whiten(s)) = s on the prior's support."""
    mc, tc, fields = pol
    bins, _, sig, dl0 = _setup(fields, BB_BINS[bb])
    rng = np.random.default_rng(2)
    dls = [d * np.exp(0.3 * rng.normal(size=(NCH, len(d)))) for d in dl0]
    x_new = [d * np.exp(0.3 * rng.normal(size=d.shape)) for d in dls]
    for f in range(2):
        ref = jcs.truncnorm_logratio(jnp.asarray(dls[f]),
                                     jnp.asarray(x_new[f]),
                                     jnp.asarray(sig[f]))
        _check(tcs.truncnorm_logratio(t64(dls[f]), t64(x_new[f]),
                                      t64(sig[f])), ref, "logratio")
    s = rng.normal(size=(NCH, 2, mc.nstate))
    dlj = tuple(jnp.asarray(d) for d in dls)
    dlt = tuple(t64(d) for d in dls)
    wj = jax.vmap(lambda s_, d_: jcs.whiten(s_, d_, bins, LMAX))(
        jnp.asarray(s), dlj)
    rj = jax.vmap(lambda s_, d_: jcs.recenter(s_, d_, bins, LMAX))(
        jnp.asarray(s), dlj)
    w = tcs.whiten(t64(s), dlt, bins, LMAX)
    _check(w, wj, "whiten")
    _check(tcs.recenter(t64(s), dlt, bins, LMAX), rj, "recenter")
    support = np.asarray(jnp.sqrt(jax.vmap(
        lambda d_: jcs._dl_tuple_to_var(d_, bins, LMAX, mc.nstate,
                                        jnp.float64))(dlj))) > 0
    _check(tcs.recenter(w, dlt, bins, LMAX), s * support, "round trip")


def test_direct_nc_cls_sample_matches_jax(pol):
    """The direct path (one likelihood per block) over n_iter = 3."""
    mc, tc, fields = pol
    bins, blocks, sig, dl0 = _setup(fields, BB_BINS["wide"])
    keys, dls, s_nc, up, ua = _inputs(mc, bins, blocks, dl0, 3, 3)
    ll_j = jcs.make_nc_log_likelihood(mc, bins, all_sph=False)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample(
        k, d, s, ll_j, bins, blocks, sig, n_iter=3)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    ll_t = tcs.make_nc_log_likelihood(tc, bins)
    dl, info = tcs.nc_cls_sample(tuple(t64(d) for d in dls), t64(s_nc), ll_t,
                                 bins, blocks, sig, n_iter=3, u_prop=up,
                                 u_acc=ua)
    for f in range(2):
        _check(dl[f], ref[0][f], f"dl[{f}]")
        np.testing.assert_array_equal(n(info.accept[f]),
                                      np.asarray(ref[1].accept[f]))
    _check(info.log_like, ref[1].log_like, "log_like")
    assert 0.0 < float(np.mean([n(a).mean() for a in info.accept])) < 1.0


CASES = [("pol", "unit"), ("pol", "wide"), ("temp", "wide")]


@pytest.mark.parametrize("sky,bb", CASES)
def test_table_engine_matches_jax(request, monkeypatch, sky, bb):
    """nc_cls_sample_cut on the table-domain engine against JAX's on the
    same keys, with chunks of at most 3 bins / 3 ells in both packages, so
    that several chunks hand the residual (Rc, Rs) across and wide bins
    go through ``seg``."""
    mc, tc, fields = request.getfixturevalue(sky)
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    bins, blocks, sig, dl0 = _setup(fields, BB_BINS[bb])
    keys, dls, s_nc, up, ua = _inputs(mc, bins, blocks, dl0, 2, 4)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
        k, d, s, mc, bins, blocks, sig, n_iter=2)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    plan = tcs.CutMHPlan(tc, bins, blocks, sig, dtype=torch.float64)
    assert len(plan.chunks) >= 2
    if bb == "wide":
        assert any(c.segj is not None for c in plan.chunks)
    dl, info = tcs.nc_cls_sample_cut(tuple(t64(d) for d in dls), t64(s_nc),
                                     tc, bins, blocks, sig, n_iter=2,
                                     u_prop=up, u_acc=ua, plan=plan)
    for f in range(len(bins)):
        _check(dl[f], ref[0][f], f"dl[{f}]")
        np.testing.assert_array_equal(n(info.accept[f]),
                                      np.asarray(ref[1].accept[f]))
    _check(info.log_like, ref[1].log_like, "log_like")
    acc = np.concatenate([n(a).ravel() for a in info.accept])
    assert 0.0 < acc.mean() < 1.0


def test_table_engine_two_big_blocks_in_a_field_match_jax(pol, monkeypatch):
    """Two multi-bin EE blocks before the BB blocks: the second EE block
    reads the state u as the first one left it (carried in place on its
    field) and the maps of both; against JAX over n_iter = 2."""
    mc, tc, fields = pol
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    bins, blocks, sig, dl0 = _setup(fields, BB_BINS["wide"])
    blocks[0] = [(0, 5), (5, len(bins[0]) - 1)]
    sig[0] = 0.1 * dl0[0]
    keys, dls, s_nc, up, ua = _inputs(mc, bins, blocks, dl0, 2, 8)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
        k, d, s, mc, bins, blocks, sig, n_iter=2)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    plan = tcs.CutMHPlan(tc, bins, blocks, sig, dtype=torch.float64)
    assert plan.big_fields == [0, 0, 1]
    dl, info = tcs.nc_cls_sample_cut(tuple(t64(d) for d in dls), t64(s_nc),
                                     tc, bins, blocks, sig, n_iter=2,
                                     u_prop=up, u_acc=ua, plan=plan)
    for f in range(2):
        _check(dl[f], ref[0][f], f"dl[{f}]")
        np.testing.assert_array_equal(n(info.accept[f]),
                                      np.asarray(ref[1].accept[f]))
    _check(info.log_like, ref[1].log_like, "log_like")
    # the first EE block accepted somewhere, so the carry was read
    assert n(info.accept[0])[..., 0].max() == 1.0


@pytest.mark.parametrize("sky,bb", CASES)
def test_table_engine_matches_own_direct_path(request, monkeypatch, sky, bb):
    """The port's fast path against its own direct nc_cls_sample on the
    same uniforms: D_ell, accepts and the final log-likelihood."""
    _, tc, fields = request.getfixturevalue(sky)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 2)
    bins, blocks, sig, dl0 = _setup(fields, BB_BINS[bb])
    rng = np.random.default_rng(5)
    dls = tuple(t64(d * np.exp(0.2 * rng.normal(size=(NCH, len(d)))))
                for d in dl0)
    s_nc = t64(valid_normal(rng, (NCH, tc.nfields, tc.nstate), LMAX))
    ntot, nblocks = sum(len(b) - 1 for b in bins), sum(map(len, blocks))
    up = t64(rng.uniform(size=(NCH, 3, ntot)))
    ua = t64(rng.uniform(size=(NCH, 3, nblocks)))
    fast = tcs.nc_cls_sample_cut(dls, s_nc, tc, bins, blocks, sig, n_iter=3,
                                 u_prop=up, u_acc=ua)
    direct = tcs.nc_cls_sample(dls, s_nc, tcs.make_nc_log_likelihood(
        tc, bins), bins, blocks, sig, n_iter=3, u_prop=up, u_acc=ua)
    for f in range(len(bins)):
        _check(fast[0][f], n(direct[0][f]), f"dl[{f}]")
        np.testing.assert_array_equal(n(fast[1].accept[f]),
                                      n(direct[1].accept[f]))
    _check(fast[1].log_like, n(direct[1].log_like), "log_like")


def _cut_rows_variant(mc, tc, kind):
    """The JAX and port cut models with their cut rows replaced, the same in
    both packages: "phased" gives every row phi0 = 0.1; "nyquist" cuts the
    rows to nphi = 2 lmax (an aliased grid, whose m = lmax column is the
    Nyquist column), with phi0 = 0.1 on every other row."""
    from gibbssampler_tpu.sht import SHT as JaxSHT
    grid = tc.cut_sht.grid
    phi0 = np.full(grid.nrings, 0.1)
    if kind == "nyquist":
        phi0[::2] = 0.0
        grid = dataclasses.replace(grid, nphi=2 * LMAX, phi0=phi0)
    else:
        grid = dataclasses.replace(grid, phi0=phi0)
    spin2 = tc.spin == 2
    jcut = JaxSHT(grid, LMAX, dtype=jnp.float64, spin2=spin2,
                  allow_aliasing=True)
    tcut = SHT(grid, LMAX, dtype=torch.float64, spin2=spin2, device="cpu",
               allow_aliasing=True)
    nphi = grid.nphi
    mc = dataclasses.replace(mc, cut_sht=jcut, d_cut=mc.d_cut[..., :nphi],
                             w_cut=mc.w_cut[..., :nphi])
    tc = dataclasses.replace(tc, cut_sht=tcut, d_cut=tc.d_cut[..., :nphi],
                             w_cut=tc.w_cut[..., :nphi])
    return mc, tc


@pytest.mark.parametrize("sky,kind", [("pol", "phased"), ("temp", "phased"),
                                      ("pol", "nyquist"),
                                      ("temp", "nyquist")])
def test_table_engine_on_phased_and_nyquist_rows(request, monkeypatch, sky,
                                                 kind):
    """The table engine's ring-phase path (raw ring sums rotated into the
    unrotated-F basis) and its Nyquist-column path (the m = lmax column
    zeroed out of the tables, its exact terms added per chunk) against
    JAX's nc_cls_sample_cut on the same keys and the port's direct
    nc_cls_sample on the same uniforms."""
    mc, tc, fields = request.getfixturevalue(sky)
    mc, tc = _cut_rows_variant(mc, tc, kind)
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    bins, blocks, sig, dl0 = _setup(fields, BB_BINS["wide"])
    keys, dls, s_nc, up, ua = _inputs(mc, bins, blocks, dl0, 2, 6)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
        k, d, s, mc, bins, blocks, sig, n_iter=2)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    plan = tcs.CutMHPlan(tc, bins, blocks, sig, dtype=torch.float64)
    assert plan.ph_c is not None
    assert all((c.lnyq is not None) == (kind == "nyquist")
               for c in plan.chunks)
    dlt = tuple(t64(d) for d in dls)
    dl, info = tcs.nc_cls_sample_cut(dlt, t64(s_nc), tc, bins, blocks, sig,
                                     n_iter=2, u_prop=up, u_acc=ua,
                                     plan=plan)
    direct = tcs.nc_cls_sample(dlt, t64(s_nc), tcs.make_nc_log_likelihood(
        tc, bins), bins, blocks, sig, n_iter=2, u_prop=up, u_acc=ua)
    for f in range(len(bins)):
        _check(dl[f], ref[0][f], f"dl[{f}]")
        _check(dl[f], n(direct[0][f]), f"dl[{f}] vs direct")
        np.testing.assert_array_equal(n(info.accept[f]),
                                      np.asarray(ref[1].accept[f]))
        np.testing.assert_array_equal(n(info.accept[f]),
                                      n(direct[1].accept[f]))
    _check(info.log_like, ref[1].log_like, "log_like")
    acc = np.concatenate([n(a).ravel() for a in info.accept])
    assert 0.0 < acc.mean() < 1.0


def _engine_cases(mc, tc, fields):
    """The configurations that take the two engines beside the table
    engine, the same in both packages: (JAX model, port model, blocks,
    keyword arguments, the engine the JAX package picks)."""
    bins, blocks, sig, dl0 = _setup(fields, BB_BINS["wide"])
    nb_bb = len(bins[1]) - 1
    rep = lambda m, **kw: dataclasses.replace(m, **kw)
    return {
        "mdomain m": (mc, tc, blocks, dict(mdomain="m"), "coef"),
        "mdomain False": (mc, tc, blocks, dict(mdomain=False), "phi"),
        "no singles": (mc, tc, [blocks[0], [(0, nb_bb)]], {}, "phi"),
        "w not uniform": (rep(mc, cut_w_uniform=False),
                          rep(tc, cut_w_uniform=False), blocks, {}, "phi"),
        "w not equal": (rep(mc, cut_w_equal_fields=False),
                        rep(tc, cut_w_equal_fields=False), blocks, {},
                        "coef"),
    }, bins, sig, dl0


REFUSALS = ["mdomain m", "mdomain False", "no singles", "w not uniform",
            "w not equal"]


@pytest.mark.parametrize("case", REFUSALS)
def test_other_engines_match_jax_and_direct(pol, monkeypatch, case):
    """Where the JAX package takes the coefficient m-domain or the
    phi-domain engine (which the port once refused), the port's plan picks
    the same engine and equals JAX's nc_cls_sample_cut on the same keys,
    and the port's direct nc_cls_sample on the same uniforms, over 2
    sweeps with chunks of at most 3 bins / 3 ells in both packages."""
    mc, tc, fields = pol
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_MDOMAIN_CHUNK", 3)
        monkeypatch.setattr(mod, "_PHI_CHUNK", 3)
    cases, bins, sig, dl0 = _engine_cases(mc, tc, fields)
    jm, tm, blocks, kw, engine = cases[case]
    keys, dls, s_nc, up, ua = _inputs(jm, bins, blocks, dl0, 2, 12)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
        k, d, s, jm, bins, blocks, sig, n_iter=2, **kw)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    plan = tcs.CutMHPlan(tm, bins, blocks, sig, dtype=torch.float64, **kw)
    assert plan.engine == engine
    dlt = tuple(t64(d) for d in dls)
    dl, info = tcs.nc_cls_sample_cut(dlt, t64(s_nc), tm, bins, blocks, sig,
                                     n_iter=2, u_prop=up, u_acc=ua,
                                     plan=plan)
    direct = tcs.nc_cls_sample(dlt, t64(s_nc), tcs.make_nc_log_likelihood(
        tm, bins), bins, blocks, sig, n_iter=2, u_prop=up, u_acc=ua)
    for f in range(2):
        _check(dl[f], ref[0][f], f"dl[{f}]")
        _check(dl[f], n(direct[0][f]), f"dl[{f}] vs direct")
        np.testing.assert_array_equal(n(info.accept[f]),
                                      np.asarray(ref[1].accept[f]))
        np.testing.assert_array_equal(n(info.accept[f]),
                                      n(direct[1].accept[f]))
    _check(info.log_like, ref[1].log_like, "log_like")
    acc = np.concatenate([n(a).ravel() for a in info.accept])
    # (the two big blocks of "no singles" may accept every move)
    assert 0.0 < acc.mean() <= (1.0 if case == "no singles" else 0.99)


def test_other_refusals(pol):
    """mh_fast="phi" pins the phi engine in the scheme's plan; the
    likelihood of a model without the cut decomposition takes the pixel
    form, the harmonic one
    (all_sph) needs ``d_alm``; a big block after a single raises
    ValueError, as in JAX; a model without holes ignores ``au_sp``, as
    JAX's does.  The
    Nyquist-column preparation zeroes the m = lmax row of each chunk's
    tables and carries it raw, as JAX's does."""
    mc, tc, fields = pol
    bins, blocks, sig, _ = _setup(fields, BB_BINS["unit"])
    chunks = [(1, np.array([10, 11, LMAX]), None, None, None)]
    w1 = tc.w_cut[0, :, 0]
    mine = tcs._prepare_tchunks(tc, tc.cut_sht, chunks, w1, torch.float64,
                                nyq=True)
    ref = jcs._prepare_tchunks(mc, mc.cut_sht, chunks,
                               jnp.asarray(n(w1)), jnp.float64, nyq=True)
    for (kind, lamA, lamB, W, _om, lnyq), rk in zip(mine, ref):
        assert kind == rk[0] == "s2"
        for a, r in ((lamA, rk[1]), (lamB, rk[2]), (W, rk[3]),
                     (lnyq[0], rk[5][0]), (lnyq[1], rk[5][1])):
            _check(a, r, "nyquist tables", rtol=1e-13)
        assert not n(lamA[LMAX]).any() and n(lnyq[0]).any()
    assert not tc.has_sparse
    u = t64(valid_normal(np.random.default_rng(8), (2, 2, tc.nstate), LMAX))
    assert torch.equal(tc.data_loglike_cut(u, au_sp=torch.zeros(1)),
                       tc.data_loglike_cut(u))
    assert ASISGibbs(tc, bins, blocks, sig,
                     mh_fast="phi").mh_plan.engine == "phi"
    assert ASISGibbs(tc, bins, blocks, sig).mh_plan.engine == "table"
    with pytest.raises(ValueError):
        tcs.make_nc_log_likelihood(tc, bins, all_sph=True)
    assert tcs.make_nc_log_likelihood(tc, bins, all_sph=True,
                                      d_alm=u).kind == "sph"
    assert tcs.make_nc_log_likelihood(tc, bins).kind == "cut"
    full = dataclasses.replace(tc, cut_sht=None)
    assert tcs.make_nc_log_likelihood(full, bins).kind == "pix"
    with pytest.raises(ValueError):
        tcs.CutMHPlan(tc, bins, [blocks[0], [(5, 6), (0, 3)]], sig)


def test_proposal_helpers_match_jax():
    """analytic_proposal_sigma and block_widths are copies of JAX's."""
    lmax = 40
    bl = np.exp(-1e-3 * np.arange(lmax + 1) ** 2)
    bins = np.array([2, 3, 5, 9, 14, 20, 30, 41])
    for f_sky in (1.0, 0.7):
        np.testing.assert_allclose(
            analytic_proposal_sigma(bl, 0.04, 1e-4, lmax, bins, f_sky=f_sky),
            jax_adapt.analytic_proposal_sigma(bl, 0.04, 1e-4, lmax, bins,
                                              f_sky=f_sky), rtol=1e-15)
    blocks = [(0, 3), (3, 4), (5, 7)]
    np.testing.assert_array_equal(block_widths(blocks, 7),
                                  jax_adapt.block_widths(blocks, 7))


def test_tuned_proposal_sigmas_picks_the_flagship_record():
    """bench.py's match rule (scheme, grid, lmax, nbins) picks the asis/gl
    lmax-512 record of tuned_proposals.json; no match raises."""
    path = ROOT / "tuned_proposals.json"
    sig = tuned_proposal_sigmas(path, "asis", "gl", 512, [511, 410])
    recs = json.loads(path.read_text())["records"]
    rec = [r for r in recs if r["scheme"] == "asis"][0]
    assert [len(s) for s in sig] == [511, 410]
    for mine, ref in zip(sig, rec["sig"]):
        np.testing.assert_array_equal(mine, np.asarray(ref))
    pn = tuned_proposal_sigmas(path, "pncp", "gl", 512, [511, 410])
    assert any(not np.array_equal(a, b) for a, b in zip(sig, pn))
    for bad in (("asis", "healpix", 512, [511, 410]),
                ("asis", "gl", 256, [511, 410]),
                ("asis", "gl", 512, [511, 409])):
        with pytest.raises(LookupError):
            tuned_proposal_sigmas(path, *bad)
