"""The port's CR steps and centered Gibbs iteration against the JAX package
on the same injected variates (float64, CPU): aux-Gibbs + MALA, and the
auxiliary family aux-Gibbs, overrelaxation, MALA and ULA on band, holey GL
and holey HEALPix cut models, with three ASIS iterations on the
overrelaxed CR; a statistical check of the MALA step; and the float32
rounding of the accept tests' exact log-ratios against the old form's.

Both packages get the same noise pool, made with numpy; the MALA accept
uniforms and the gamma variates are recomputed here from the same
``jax.random.split``s that the JAX functions make, and handed to the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_mh_uniforms, jax_model_arrays, make_holey,
                          make_holey_healpix, make_masked, n, port_model, t64,
                          valid_normal)
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.inference import example_dl, simulate_dataset
from gibbssampler_tpu.samplers import aux_then_mala_cr as jax_aux_mala
from gibbssampler_tpu.samplers import cr as jcr
from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
from gibbssampler_tpu.schemes import CenteredGibbs as JaxCentered
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu_torch.harmonics import variance_expansion_state
from gibbssampler_tpu_torch.interop import model_from_numpy, state_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.samplers import aux_then_mala_cr, mala_cr
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.samplers import cr as tcr
from gibbssampler_tpu_torch.samplers.cls_samplers import standard_gamma
from gibbssampler_tpu_torch.schemes import ASISGibbs, CenteredGibbs

LMAX = 10
NCH = 3
BINS = np.array([2, 3, 4, 6, 8, 11])
OPTS = {"n_gibbs": 1, "tau": 0.02}
RTOL = 1e-9


def _pool(mc, seed):
    """{kind: (nchains, K, *shape)} for aux_mala with n_gibbs = 1."""
    rng = np.random.default_rng(seed)
    return {"state": rng.normal(size=(NCH, 2, mc.nfields, mc.nstate)),
            "aux": rng.normal(size=(NCH, 1) + tuple(mc.w_cut.shape))}


def _mala_uniform(key):
    """The uniform of aux_then_mala_cr(key): split -> mala_cr(k2) ->
    split -> uniform(ka)."""
    _, k2 = jax.random.split(key)
    _, ka = jax.random.split(k2)
    return float(jax.random.uniform(ka, dtype=jnp.float64))


def _dl_chains(fields, seed):
    """Per-field (nchains, nbins) binned D_ell, scattered around truth."""
    rng = np.random.default_rng(seed)
    return tuple(np.array([[f[lo:hi].mean() for lo, hi in zip(BINS[:-1],
                                                              BINS[1:])]])
                 * np.exp(0.3 * rng.normal(size=(NCH, len(BINS) - 1)))
                 for f in fields)


@pytest.fixture(scope="module")
def masked():
    """(JAX cut model, port cut model, fields) of one band-masked dataset."""
    _, mc, fields = make_masked(spin=2, sigma2=0.5)
    return mc, port_model(mc, cut=True), fields


def _check(mine, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(mine), ref, rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


@pytest.mark.parametrize("tau", [0.02, 0.5])
def test_aux_then_mala_matches_jax(masked, tau):
    """One composed aux-Gibbs + MALA step per chain; at tau = 0.5 some
    proposals are rejected, so both accept branches are compared."""
    mc, tc, fields = masked
    dls = _dl_chains(fields, 1)
    scheme = JaxCentered(mc, [BINS, BINS], cr_method="aux_mala",
                         cr_options=OPTS)
    var = np.stack([np.asarray(scheme.var_cls(tuple(jnp.asarray(d[c])
                                                    for d in dls)))
                    for c in range(NCH)])
    s_old = np.sqrt(var) * np.random.default_rng(2).normal(size=var.shape)
    pool = _pool(mc, 3)
    bt = mc.bt_ninv_d()
    keys = jax.random.split(jax.random.PRNGKey(4), NCH)
    ref = [jax_aux_mala(keys[c], mc, jnp.asarray(var[c]), bt,
                        jnp.asarray(s_old[c]), n_gibbs=1, tau=tau,
                        noise={k: jnp.asarray(v[c]) for k, v in pool.items()})
           for c in range(NCH)]
    u = t64([_mala_uniform(k) for k in keys])
    s_new, info = aux_then_mala_cr(tc, t64(var), tc.bt_ninv_d(), t64(s_old),
                                   n_gibbs=1, tau=tau,
                                   noise={k: t64(v) for k, v in pool.items()},
                                   u=u)
    _check(s_new, np.stack([np.asarray(r[0]) for r in ref]), "s")
    _check(info.extra, [float(r[1].extra) for r in ref], "extra")
    np.testing.assert_array_equal(n(info.accept),
                                  [float(r[1].accept) for r in ref])
    if tau == 0.5:
        assert 0.0 in n(info.accept)


def test_centered_step_matches_jax(masked):
    """One CenteredGibbs.step (aux_mala CR + inverse-gamma D_ell draws)."""
    mc, tc, fields = masked
    jsch = JaxCentered(mc, [BINS, BINS], cr_method="aux_mala",
                       cr_options=OPTS)
    tsch = CenteredGibbs(tc, [BINS, BINS], cr_method="aux_mala",
                         cr_options=OPTS)
    _check(tsch.bt_ninv_d, jsch.bt_ninv_d, "bt_ninv_d")
    dls = _dl_chains(fields, 5)
    var = np.stack([np.asarray(jsch.var_cls(tuple(jnp.asarray(d[c])
                                                  for d in dls)))
                    for c in range(NCH)])
    s = np.sqrt(var) * np.random.default_rng(6).normal(size=var.shape)
    pool = _pool(mc, 7)
    keys = jax.random.split(jax.random.PRNGKey(8), NCH)
    ref = [jsch.step(keys[c], JaxState(s=jnp.asarray(s[c]),
                                       dl=tuple(jnp.asarray(d[c])
                                                for d in dls)),
                     {k: jnp.asarray(v[c]) for k, v in pool.items()})
           for c in range(NCH)]
    # step(key): k1 -> CR, k2 -> split(k2, nfields) -> gamma per field
    ell = jnp.arange(LMAX + 1, dtype=jnp.float64)
    alpha = jax_bin_sum(2.0 * ell + 1.0, BINS, LMAX) / 2.0 - 1.0
    alpha = jnp.where(alpha <= 0, 1.0, alpha)
    u, gam = [], [[], []]
    for key in keys:
        k1, k2 = jax.random.split(key)
        u.append(_mala_uniform(k1))
        for f, kf in enumerate(jax.random.split(k2, 2)):
            gam[f].append(np.asarray(jax.random.gamma(kf, alpha)))
    new, info = tsch.step(state_from_numpy(s, dls, device="cpu"),
                          noise={k: t64(v) for k, v in pool.items()},
                          u=t64(u), gammas=tuple(t64(g) for g in gam))
    _check(new.s, np.stack([np.asarray(r[0].s) for r in ref]), "s")
    for f in range(2):
        _check(new.dl[f], np.stack([np.asarray(r[0].dl[f]) for r in ref]),
               f"dl[{f}]")
    np.testing.assert_array_equal(n(info["cr_accept"]),
                                  [float(r[1]["cr_accept"]) for r in ref])


def test_standard_gamma_moments():
    """The generator-driven Marsaglia-Tsang sampler: mean alpha and
    variance alpha over the shapes the conjugate draw uses; alpha < 1 is
    refused."""
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        standard_gamma(t64([0.5, 2.0]), gen)
    alpha = t64(np.repeat([1.0, 1.5, 2.5, 40.0], 20000).reshape(4, -1))
    g = n(standard_gamma(alpha, gen))
    a = n(alpha)[:, 0]
    assert (g > 0).all()
    se = np.sqrt(a / g.shape[1])
    np.testing.assert_allclose(g.mean(axis=1), a, atol=6 * se.max())
    np.testing.assert_allclose(g.var(axis=1), a, rtol=0.1)


def test_mala_acceptance_and_invariance():
    """Mirrors test_ops_samplers.py::test_mala_acceptance_and_invariance on
    the port (full-grid masked path, all chains in one call): started from
    exact draws of the masked posterior, one MALA step accepts mostly and
    keeps the posterior mean.  The exact draws come from a dense Cholesky
    factor of Q, built column by column with the port's own q_apply."""
    lmax = 8
    dl = example_dl(lmax)
    nr, nphi = lmax + 1, 2 * lmax + 2
    mask = np.ones((nr, nphi))
    mask[int(nr * 0.4): int(nr * 0.6)] = 0.0
    model, _ = simulate_dataset(jax.random.PRNGKey(0), lmax, spin=0,
                                dl_fields=dl[None], noise_sigma2=1.0,
                                mask=mask, dtype=jnp.float64)
    tm = model_from_numpy(jax_model_arrays(model), device="cpu")
    var = n(variance_expansion_state(t64(dl), lmax))[None]
    inv = np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)
    act = np.flatnonzero(var[0] > 0)
    eye = np.zeros((act.size, 1, var.shape[1]))
    eye[np.arange(act.size), 0, act] = 1.0
    Q = n(tm.q_apply(t64(eye), t64(inv)))[:, 0, act]
    bt = tm.bt_ninv_d()
    chol = np.linalg.cholesky(0.5 * (Q + Q.T))
    mean = np.linalg.solve(Q, n(bt)[0, act])
    nch = 400
    z = np.random.default_rng(10).normal(size=(act.size, nch))
    ref = np.zeros((nch, 1, var.shape[1]))
    ref[:, 0, act] = (mean[:, None] + np.linalg.solve(chol.T, z)).T
    gen = torch.Generator().manual_seed(11)
    moved, info = mala_cr(tm, t64(var), bt, t64(ref), tau=0.02, gen=gen)
    assert info.accept.shape == (nch,)
    acc = float(info.accept.mean())
    assert acc > 0.5, acc
    m_ref, m_new = ref.mean(0), n(moved).mean(0)
    scale = float(np.sqrt(ref.var(0)).max())
    np.testing.assert_allclose(m_new[0, 2:40], m_ref[0, 2:40],
                               atol=6 * scale / np.sqrt(nch))


# ---------------------------------------------------------------------------
# The auxiliary CR family on band, holey GL and holey HEALPix cut models
# ---------------------------------------------------------------------------

CUT_MODELS = {
    "band": lambda: make_masked(spin=2, sigma2=0.5)[1:],
    "holey": lambda: make_holey(2)[1:],
    "holey_healpix": lambda: make_holey_healpix(2)[1:],
}


@pytest.fixture(scope="module")
def cut_models():
    """{name: (JAX cut model, port cut model, fields)}, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            mc, fields = CUT_MODELS[name]()
            cache[name] = (mc, port_model(mc, cut=True), fields)
        return cache[name]
    return get


def _family_inputs(mc, fields, n_gibbs, seed):
    """Per-chain prior variances, start states and a noise pool with room
    for every method at ``n_gibbs`` sweeps."""
    from gibbssampler_tpu.harmonics import variance_expansion_state as jvar
    rng = np.random.default_rng(seed)
    lmax = mc.lmax
    var = np.stack([np.asarray(jvar(jnp.asarray(f), lmax)) for f in fields])
    var = var[None] * np.exp(0.2 * rng.normal(size=(NCH, 1, 1)))
    s_old = np.sqrt(var) * rng.normal(size=var.shape)
    pool = {"state": rng.normal(size=(NCH, 2 * n_gibbs, mc.nfields,
                                      mc.nstate)),
            "aux": rng.normal(size=(NCH, 1 + n_gibbs) + tuple(mc.w_cut.shape))}
    if mc.has_sparse:
        pool["sp"] = rng.normal(size=(NCH, 1 + n_gibbs)
                                + tuple(mc.w_sp.shape))
    return var, s_old, pool


@pytest.mark.parametrize("name", sorted(CUT_MODELS))
@pytest.mark.parametrize("method", ["aux_gibbs", "overrelax", "mala", "ula"])
def test_aux_cr_family_matches_jax(cut_models, name, method):
    """aux_gibbs_cr (2 sweeps), overrelax_cr (alpha -0.995, 2 sweeps: the
    variates in JAX's order), mala_cr and the ULA step (mala_cr with
    accept=False) of every chain at once against JAX's vmapped functions on
    the same pools (and MALA accept uniforms): states, accepts and
    CRInfo.extra to 1e-9."""
    mc, tc, fields = cut_models(name)
    n_gibbs = 2
    var, s_old, pool = _family_inputs(mc, fields, n_gibbs, 3)
    bt = mc.bt_ninv_d()
    keys = jax.random.split(jax.random.PRNGKey(4), NCH)
    tpool = {k: t64(v) for k, v in pool.items()}
    tbt = tc.bt_ninv_d()
    if method == "aux_gibbs":
        fn = lambda k, v, s, p: jcr.aux_gibbs_cr(k, mc, v, bt, s,
                                                 n_gibbs=n_gibbs, noise=p)
        mine = tcr.aux_gibbs_cr(tc, t64(var), tbt, t64(s_old),
                                n_gibbs=n_gibbs, noise=tpool)
    elif method == "overrelax":
        fn = lambda k, v, s, p: jcr.overrelax_cr(k, mc, v, bt, s,
                                                 alpha=-0.995,
                                                 n_gibbs=n_gibbs, noise=p)
        mine = tcr.overrelax_cr(tc, t64(var), tbt, t64(s_old), alpha=-0.995,
                                n_gibbs=n_gibbs, noise=tpool)
    else:
        accept = method == "mala"
        fn = lambda k, v, s, p: jcr.mala_cr(k, mc, v, bt, s, tau=0.5,
                                            accept=accept, noise=p)
        # mala_cr(key): kp, ka = split(key); the accept uniform from ka
        u = t64([float(jax.random.uniform(jax.random.split(k)[1],
                                          dtype=jnp.float64)) for k in keys])
        mine = tcr.mala_cr(tc, t64(var), tbt, t64(s_old), tau=0.5,
                           accept=accept, noise=tpool, u=u)
    ref = jax.vmap(fn)(keys, jnp.asarray(var), jnp.asarray(s_old),
                       {k: jnp.asarray(v) for k, v in pool.items()})
    _check(mine[0], ref[0], f"{method} state")
    _check(mine[1].extra, ref[1].extra, f"{method} extra")
    np.testing.assert_array_equal(n(mine[1].accept), np.asarray(
        ref[1].accept))


def test_asis_steps_match_jax_with_overrelax(masked, monkeypatch):
    """Three ASISGibbs iterations with cr="overrelax" (bench.py's options:
    alpha -0.995, one sweep): the JAX scheme's vmapped step and the port's
    batched step on the same pools, gamma variates and MH uniforms agree at
    every iteration; the MH accepts are equal."""
    from gibbssampler_tpu.samplers import cls_samplers as jcs
    mc, tc, fields = masked
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 2)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 2)
    bins = [BINS, BINS]
    blocks = [[(0, 5)], [(0, 2)] + [(i, i + 1) for i in range(2, 5)]]
    dl0 = [np.array([f[lo:hi].mean() for lo, hi in zip(BINS[:-1], BINS[1:])])
           for f in fields]
    sig = [0.3 * d for d in dl0]
    opts = {"alpha": -0.995, "n_gibbs": 1}
    kw = dict(n_iter_mh=1, cr_method="overrelax", cr_options=opts)
    jsch = JaxASIS(mc, bins, blocks, sig, **kw)
    tsch = ASISGibbs(tc, bins, blocks, sig, **kw)
    assert jsch._use_cut_mh and tsch._use_cut_mh
    assert set(tsch.draw_noise_pool(NCH, torch.Generator())) == {"state",
                                                                 "aux"}
    jstep = jax.jit(jax.vmap(jsch.step))
    dls = tuple(np.tile(d, (NCH, 1)) for d in dl0)
    var = np.asarray(jax.vmap(jsch.var_cls)(tuple(jnp.asarray(d)
                                                  for d in dls)))
    s0 = np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(jnp.asarray(d)
                                                  for d in dls))
    tstate = state_from_numpy(s0, dls, device="cpu")
    ell = jnp.arange(LMAX + 1, dtype=jnp.float64)
    alpha = jnp.where(jax_bin_sum(2.0 * ell + 1.0, BINS, LMAX) / 2.0 - 1.0
                      <= 0, 1.0,
                      jax_bin_sum(2.0 * ell + 1.0, BINS, LMAX) / 2.0 - 1.0)
    ntot, nblocks = 2 * (len(BINS) - 1), sum(map(len, blocks))
    rng = np.random.default_rng(1)
    for it in range(3):
        pool = {"state": rng.normal(size=(NCH, 2, 2, tc.nstate)),
                "aux": rng.normal(size=(NCH, 2) + tuple(tc.w_cut.shape))}
        keys = jax.random.split(jax.random.PRNGKey(200 + it), NCH)
        jstate, jinfo = jstep(keys, jstate,
                              {k: jnp.asarray(v) for k, v in pool.items()})
        # step(key): k1 -> the CR step (pool only), k2 -> gammas, k3 -> MH
        gam, up, ua = [[], []], [], []
        for key in keys:
            _, k2, k3 = jax.random.split(key, 3)
            for f, kf in enumerate(jax.random.split(k2, 2)):
                gam[f].append(np.asarray(jax.random.gamma(kf, alpha)))
            p_, a_ = jax_mh_uniforms(k3, 1, ntot, nblocks)
            up.append(p_)
            ua.append(a_)
        tstate, tinfo = tsch.step(
            tstate, noise={k: t64(v) for k, v in pool.items()},
            gammas=tuple(t64(g) for g in gam), u_prop=t64(up), u_acc=t64(ua))
        _check(tstate.s, jstate.s, f"iteration {it} s")
        for f in range(2):
            _check(tstate.dl[f], jstate.dl[f], f"iteration {it} dl[{f}]")
            np.testing.assert_array_equal(n(tinfo["mh_accept"][f]),
                                          np.asarray(jinfo["mh_accept"][f]))


# ---------------------------------------------------------------------------
# float32: the exact log-ratios against the old form's
# ---------------------------------------------------------------------------

def _models_32_64(lmax=16):
    """A band-masked flagship-like sky (amp 1000, noise 0.2^2) whose fields
    are rounded to float32, as one float32 and one float64 cut model with
    the same parameters."""
    from gibbssampler_tpu_torch.inference import (example_dl as t_dl,
                                                  simulate_dataset as t_sim)
    gen = torch.Generator().manual_seed(0)
    theta = np.arccos(np.polynomial.legendre.leggauss(lmax + 1)[0][::-1])
    keep = (np.abs(np.pi / 2 - theta) > 0.2).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (lmax + 1, 2 * lmax + 2))
    dls = np.stack([t_dl(lmax, "ee"), t_dl(lmax, "bb")])
    model, _ = t_sim(lmax, 2, dls, 0.2 ** 2, fwhm_radians=np.radians(0.5),
                     mask=mask, dtype=torch.float64, device="cpu", gen=gen)
    g = model.sht.grid
    r32 = lambda a: np.asarray(a, dtype=np.float32).astype(np.float64)
    arrays = {"d": r32(model.d), "tau": r32(model.noise.tau),
              "q_map": r32(model.noise.q_map), "omega": model.noise.omega,
              "bl": r32(model.bl), "spin": 2, "theta": g.theta,
              "weights": g.weights, "phi0": g.phi0, "nphi": g.nphi}
    return dls, [with_cut_decomposition(model_from_numpy(arrays, "cpu", dt))
                 for dt in (torch.float32, torch.float64)]


def test_float32_log_ratios_beat_the_old_form():
    """On a small cut model in float32: the first big block's log-ratio
    (CutMHPlan.big_dll) and the MALA log-ratio (mala_log_ratio), each
    against the same log-ratio in float64 on the same candidate, are at
    least as close as the old form's (differences of float32 totals) in
    the median over 16 chains, and within 1e-3 nats (tolerance)."""
    lmax, nch = 16, 16
    dls, (m32, m64) = _models_32_64(lmax)
    bins = [np.arange(2, lmax + 2)] * 2
    blocks = [[(0, 15)], [(0, 10)] + [(i, i + 1) for i in range(10, 15)]]
    dl0 = np.concatenate([[d[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])]
                          for d, b in zip(dls, bins)])
    rng = np.random.default_rng(1)
    dl = dl0 * np.exp(0.1 * rng.normal(size=(nch, dl0.size)))
    s_nc = valid_normal(rng, (nch, 2, m32.nstate), lmax)
    sig = [0.05 * dl0[:15], 0.05 * dl0[15:]]
    up = rng.uniform(size=dl.shape)
    errs = {}
    vals = []
    for m, dt in ((m32, torch.float32), (m64, torch.float64)):
        plan = tcs.CutMHPlan(m, bins, blocks, sig, dtype=dt)
        d = torch.as_tensor(dl, dtype=dt)
        cand = torch.where(plan.bmask[0] > 0, tcs.propose_truncnorm(
            d, plan.sigma, torch.as_tensor(up, dtype=dt)), d)
        if dt == torch.float32:
            cand32 = cand
        else:
            cand = cand32.to(dt)
        _, tv = plan.components(torch.as_tensor(s_nc, dtype=dt))
        u = plan.u_of(d, tv)
        au, au_sp = m.synthesis_cut_sp(u)
        new = plan.big_dll(tv, d, cand, u, au, au_sp, plan.big_fields[0])[0]
        old = m.data_loglike_cut(plan.u_of(cand, tv)) - m.data_loglike_cut(
            u, au, au_sp)
        vals.append((new.double(), old.double()))
    ref = vals[1][0]
    errs["big block"] = [n((v - ref).abs()) for v in vals[0]]
    var = np.stack([n(variance_expansion_state(t64(f), lmax)) for f in dls])
    s = np.sqrt(var) * valid_normal(rng, (nch, 2, m32.nstate), lmax)
    xi = rng.normal(size=s.shape)
    out = []
    for m, dt in ((m32, torch.float32), (m64, torch.float64)):
        tt = lambda a: torch.as_tensor(a, dtype=dt)
        v = tt(var).expand(nch, -1, -1)
        bt = m.bt_ninv_d()
        if dt == torch.float32:
            s_prop = tcr.mala_cr(m, v, bt, tt(s), tau=0.02, accept=False,
                                 noise={"state": tt(xi)[:, None]})[0]
            out += [tcr.mala_log_ratio(m, v, bt, tt(s) * (v > 0), s_prop,
                                       0.02, exact=e).double()
                    for e in (True, False)]
        else:
            out.append(tcr.mala_log_ratio(m, v, bt, tt(s) * (v > 0),
                                          s_prop.to(dt), 0.02))
    errs["MALA"] = [n((x - out[2]).abs()) for x in out[:2]]
    for what, (new, old) in errs.items():
        assert np.median(new) <= np.median(old), (what, np.median(new),
                                                  np.median(old))
        assert new.max() <= 1e-3, (what, new.max())
