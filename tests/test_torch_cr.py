"""The port's CR step and centered Gibbs iteration against the JAX package
on the same injected variates (float64, CPU), and a statistical check of
its MALA step.

Both packages get the same noise pool, made with numpy; the MALA accept
uniforms and the gamma variates are recomputed here from the same
``jax.random.split``s that the JAX functions make, and handed to the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import jax_model_arrays, make_masked, n, port_model, t64
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.inference import example_dl, simulate_dataset
from gibbssampler_tpu.samplers import aux_then_mala_cr as jax_aux_mala
from gibbssampler_tpu.schemes import CenteredGibbs as JaxCentered
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu_torch.harmonics import variance_expansion_state
from gibbssampler_tpu_torch.interop import model_from_numpy, state_from_numpy
from gibbssampler_tpu_torch.samplers import aux_then_mala_cr, mala_cr
from gibbssampler_tpu_torch.samplers.cls_samplers import standard_gamma
from gibbssampler_tpu_torch.schemes import CenteredGibbs

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
