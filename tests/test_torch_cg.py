"""The port's batched CG solver and the CG family of the CR portfolio
against the JAX package (float64, CPU): ``cg_solve`` against ``jax.vmap``
of JAX's (per-chain iterations equal), the mixed-precision path against a
dense solve, ``fluctuated_rhs``, ``cr_precond``, ``cg_cr``, ``rjpo_cr`` and
``pcn_cr`` on band-cut, holey (sparse split) and full-grid masked models,
two ``CenteredGibbs`` steps with each method; and statistical mirrors of
the JAX package's tests of the same samplers.

Both packages get the same noise pools, made with numpy; the RJPO and pCN
accept uniforms are recomputed here from the ``jax.random.split`` the JAX
functions make and handed to the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_model_arrays, make_holey, make_masked, n,
                          port_model, t64)
from gibbssampler_tpu.harmonics import variance_expansion_state as jvar
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.inference import example_dl, simulate_dataset
from gibbssampler_tpu.ops import cg_solve as jax_cg_solve
from gibbssampler_tpu.samplers import cr as jcr
from gibbssampler_tpu.schemes import CenteredGibbs as JaxCentered
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu_torch.interop import model_from_numpy, state_from_numpy
from gibbssampler_tpu_torch.ops import cg_solve
from gibbssampler_tpu_torch.samplers import cr as tcr
from gibbssampler_tpu_torch.schemes import CR_METHODS, CenteredGibbs

NCH = 3
RTOL = 1e-9
BINS = np.array([2, 3, 4, 6, 8, 11])


def _check(mine, ref, what, rtol=RTOL, atol=0.0):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        n(mine), ref, rtol=rtol,
        atol=max(atol, rtol * max(1e-300, float(np.abs(ref).max()))),
        err_msg=what)


def _ring_mask(lmax, frac=0.3):
    """A band of whole rings masked (tests/test_ops_samplers.py::ring_mask)
    on the lmax GL grid."""
    nr, nphi = lmax + 1, 2 * lmax + 2
    m = np.ones((nr, nphi))
    m[int(nr * (0.5 - frac / 2)): int(nr * (0.5 + frac / 2))] = 0.0
    return m


def _full_grid_model(spin, lmax=8, sigma2=1.0, mask=None, seed=0):
    """A JAX dataset on the GL grid without the cut decomposition and the
    port's model of it; ``mask`` None is the full sky."""
    fields = (example_dl(lmax)[None] if spin == 0 else
              np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                mask=mask, dtype=jnp.float64)
    return model, model_from_numpy(jax_model_arrays(model), device="cpu"), \
        fields


def _inv(var):
    return np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)


def _chain_vars(fields, lmax, seed, nch=NCH):
    """Per-chain prior variances (nch, nf, nstate), scaled apart so that
    the chains' systems differ."""
    rng = np.random.default_rng(seed)
    var = np.stack([np.asarray(jvar(jnp.asarray(f), lmax)) for f in fields])
    return var[None] * np.exp(0.5 * rng.normal(size=(nch, 1, 1)))


# ---------------------------------------------------------------------------
# cg_solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("maxiter", [400, 9])
def test_cg_solve_matches_vmapped_jax(spin, maxiter):
    """The plain path on a masked full-grid model, each chain with its own
    prior (1e-2, 1 and 1e2 times the spectrum) and right-hand side (one
    on a seventh of the slots), so the chains converge at different
    iterations, against jax.vmap of JAX's cg_solve:
    x, residual norms, per-chain iterations and convergence flags.  At
    maxiter 9 the slow chains stop at the cap, unconverged."""
    lmax = 8
    jm, tm, fields = _full_grid_model(spin, lmax, mask=_ring_mask(lmax))
    var = _chain_vars(fields, lmax, 1) * np.array([1e-2, 1.0, 1e2])[:, None,
                                                                 None]
    rng = np.random.default_rng(2)
    b = rng.normal(size=var.shape) * (var > 0)
    b[1] *= 0.1
    b[2] = np.where(np.arange(var.shape[-1]) % 7 == 0, b[2], 0.0)
    inv = _inv(var)
    pre = np.stack([np.asarray(jcr.cr_precond(jm, jnp.asarray(v)))
                    for v in var])

    def jsolve(b_, ic, p_):
        return jax_cg_solve(lambda x: jm.q_apply(x, ic), b_, precond_diag=p_,
                            tol=1e-9, maxiter=maxiter, ndim_sys=2)
    rx, rinfo = jax.vmap(jsolve)(jnp.asarray(b), jnp.asarray(inv),
                                 jnp.asarray(pre))
    x, info = cg_solve(lambda v: tm.q_apply(v, t64(inv)), t64(b),
                       precond_diag=tcr.cr_precond(tm, t64(var)), tol=1e-9,
                       maxiter=maxiter, ndim_sys=2)
    np.testing.assert_array_equal(n(info.iterations),
                                  np.asarray(rinfo.iterations))
    np.testing.assert_array_equal(n(info.converged),
                                  np.asarray(rinfo.converged))
    _check(x, rx, "x")
    # at convergence the residual is ~tol ||b||, formed from rounding-level
    # differences: compare it to 1e-9 of ||b||
    bnorm = np.sqrt((b * b).sum(axis=(1, 2)))
    np.testing.assert_allclose(n(info.residual_norm),
                               np.asarray(rinfo.residual_norm), rtol=RTOL,
                               atol=RTOL * bnorm.min(), err_msg="residual")
    its = n(info.iterations)
    if maxiter == 9:
        # the chains still short of the tolerance stop at the cap
        capped = its == 9
        assert capped.any() and not n(info.converged)[capped].any()
    else:
        assert n(info.converged).all() and len(set(its.tolist())) > 1, its


def _dense_q(tm, var):
    """Q of the port's full-grid model as a dense matrix on the active
    slots (columns from q_apply of unit vectors), the active slot indices
    and the float64 operator."""
    inv = t64(_inv(var))
    op = lambda x: tm.q_apply(x, inv)
    shape = var.shape
    act = np.flatnonzero(var.reshape(-1) > 0)
    eye = np.zeros((act.size,) + shape)
    eye.reshape(act.size, -1)[np.arange(act.size), act] = 1.0
    Q = n(op(t64(eye))).reshape(act.size, -1)[:, act]
    return Q, act, op


def test_cg_mixed_precision_matches_dense_solve():
    """Mirrors tests/test_ops_samplers.py::test_cg_mixed_precision_matches_
    dense_solve on the port, for two chains at once: a float32 apply (the
    same model built in float32), float64 vectors, the float64 operator
    for the true residuals, replacement every 10 iterations.  Each chain
    converges to the dense solution (3e-5 of its scale), in at most
    2 x + 10 of the float64 path's iterations."""
    lmax = 8
    mask = _ring_mask(lmax)
    jm, tm, fields = _full_grid_model(2, lmax, mask=mask)
    tm32 = model_from_numpy(jax_model_arrays(jm), device="cpu",
                            dtype=torch.float32)
    var = _chain_vars(fields, lmax, 3, nch=1)[0]
    Q, act, op = _dense_q(tm, var)
    rng = np.random.default_rng(3)
    b = rng.normal(size=(2,) + var.shape) * (var > 0)
    b[1] *= 1e3
    dense = np.zeros_like(b)
    for c in range(2):
        dense[c].reshape(-1)[act] = np.linalg.solve(Q, b[c].reshape(-1)[act])
    inv32 = torch.as_tensor(_inv(var), dtype=torch.float32)
    pre = tcr.cr_precond(tm, t64(var))
    x, info = cg_solve(lambda v: tm32.q_apply(v, inv32), t64(b),
                       precond_diag=pre, tol=1e-6, maxiter=2000,
                       apply_dtype=torch.float32, operator_hi=op,
                       replace_every=10)
    assert n(info.converged).all()
    assert x.dtype == torch.float64
    for c in range(2):
        np.testing.assert_allclose(n(x[c]), dense[c],
                                   atol=3e-5 * np.abs(dense[c]).max())
    _, info64 = cg_solve(op, t64(b), precond_diag=pre, tol=1e-6,
                         maxiter=2000)
    assert (n(info.iterations) <= 2 * n(info64.iterations) + 10).all()


def test_mixed_final_choice_compares_true_residuals():
    """The JAX package's mixed path ends by comparing the last iterate's
    RECURRENCE residual with the best replacement point's TRUE residual
    (gibbssampler_tpu/ops/cg.py:212), so it can return a worse iterate and
    call it converged; the port compares true residuals.  Case: the low
    precision apply is Q / 3, so the recurrence converges (in n steps, before
    any replacement) to 3 Q^-1 b, whose true residual is 2 ||b||, while the
    start x = 0 has ||b||.  The port returns the start, not converged,
    residual ||b|| (against a dense computation, not against JAX)."""
    rng = np.random.default_rng(4)
    A = np.diag(rng.uniform(1.0, 2.0, size=4))
    b = rng.normal(size=(2, 4))
    low = torch.as_tensor(A / 3.0, dtype=torch.float32)
    x, info = cg_solve(lambda v: v @ low, t64(b), tol=1e-5, maxiter=50,
                       ndim_sys=1, apply_dtype=torch.float32,
                       operator_hi=lambda v: v @ t64(A), replace_every=10)
    np.testing.assert_array_equal(n(x), 0.0)
    assert not n(info.converged).any()
    _check(info.residual_norm, np.linalg.norm(b, axis=1), "residual")
    assert (n(info.iterations) == 4).all()
    # the last iterate is 3 A^-1 b, with true residual 2 ||b||
    x_last = 3.0 * np.linalg.solve(A, b.T).T
    np.testing.assert_allclose(np.linalg.norm(b - x_last @ A, axis=1),
                               2.0 * np.linalg.norm(b, axis=1))


# ---------------------------------------------------------------------------
# the CG family on band-cut, holey and full-grid models
# ---------------------------------------------------------------------------

def _full_grid_masked():
    """The band-masked dataset of make_masked without the cut
    decomposition (the plain masked Q apply)."""
    jm, _, fields = make_masked(spin=2, sigma2=0.5)
    return jm, fields


MODELS = {
    "band": lambda: make_masked(spin=2, sigma2=0.5)[1:],
    "holey": lambda: make_holey(2)[1:],
    "full grid": _full_grid_masked,
}


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, port model, fields)}, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, fields = MODELS[name]()
            cache[name] = (jm, port_model(jm, cut=jm.has_cut,
                                          sparse_split=jm.has_sparse or None),
                           fields)
        return cache[name]
    return get


def _inputs(jm, fields, seed):
    """Per-chain prior variances and start states, a state + pix pool."""
    rng = np.random.default_rng(seed)
    var = _chain_vars(fields, jm.lmax, seed)
    s_old = np.sqrt(var) * rng.normal(size=var.shape)
    pool = {"state": rng.normal(size=(NCH, 1, jm.nfields, jm.nstate)),
            "pix": rng.normal(size=(NCH, 1) + tuple(jm.noise.tau.shape))}
    return var, s_old, pool


def _accept_uniforms(keys):
    """The accept uniform of rjpo_cr / pcn_cr(key): split(key)[1]."""
    return t64([float(jax.random.uniform(jax.random.split(k)[1],
                                         dtype=jnp.float64)) for k in keys])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fluctuated_rhs_and_precond_match_jax(models, name):
    jm, tm, fields = models(name)
    assert tm.has_cut == jm.has_cut and tm.has_sparse == jm.has_sparse
    var, _, pool = _inputs(jm, fields, 1)
    ref = jax.vmap(lambda v, p: jcr.fluctuated_rhs(
        jax.random.PRNGKey(0), jm, v, jm.bt_ninv_d(), noise=p))(
            jnp.asarray(var), {k: jnp.asarray(v) for k, v in pool.items()})
    got = tcr.fluctuated_rhs(tm, t64(var), tm.bt_ninv_d(),
                             noise={k: t64(v) for k, v in pool.items()})
    _check(got, ref, "fluctuated_rhs")
    _check(tcr.cr_precond(tm, t64(var)),
           jax.vmap(lambda v: jcr.cr_precond(jm, v))(jnp.asarray(var)),
           "cr_precond")


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("method", ["cg", "rjpo", "rjpo loose", "pcn"])
def test_cg_family_matches_jax(models, name, method):
    """cg_cr (tol 1e-9: per-chain iterations in CRInfo.extra), rjpo_cr
    (tol 1e-8, and "loose": one iteration from a start 50x out, so that
    moves are rejected) and
    pcn_cr (beta 0.3) of every chain at once against JAX's vmapped
    functions on the same pools and accept uniforms: states, accepts and
    CRInfo.extra to 1e-9."""
    jm, tm, fields = models(name)
    var, s_old, pool = _inputs(jm, fields, 2)
    bt, tbt = jm.bt_ninv_d(), tm.bt_ninv_d()
    keys = jax.random.split(jax.random.PRNGKey(5), NCH)
    tpool = {k: t64(v) for k, v in pool.items()}
    u = _accept_uniforms(keys)
    if method == "cg":
        fn = lambda k, v, s, p: jcr.cg_cr(k, jm, v, bt, tol=1e-9, noise=p)
        mine = tcr.cg_cr(tm, t64(var), tbt, tol=1e-9, noise=tpool)
    elif method.startswith("rjpo"):
        kw = dict(tol=1e-8)
        if method == "rjpo loose":
            # one iteration from a start far out in the tails
            kw = dict(tol=0.0, maxiter=1)
            s_old = 50.0 * s_old
        fn = lambda k, v, s, p: jcr.rjpo_cr(k, jm, v, bt, s, noise=p, **kw)
        mine = tcr.rjpo_cr(tm, t64(var), tbt, t64(s_old), noise=tpool, u=u,
                           **kw)
    else:
        pool = {"state": pool["state"]}
        fn = lambda k, v, s, p: jcr.pcn_cr(k, jm, v, bt, s, beta=0.3,
                                           noise=p)
        mine = tcr.pcn_cr(tm, t64(var), tbt, t64(s_old), beta=0.3,
                          noise={"state": tpool["state"]}, u=u)
    ref = jax.vmap(fn)(keys, jnp.asarray(var), jnp.asarray(s_old),
                       {k: jnp.asarray(v) for k, v in pool.items()})
    _check(mine[0], ref[0], f"{method} state")
    # RJPO's log-ratio of a converged solve is a sum that cancels to
    # rounding level: compare it to 1e-12 nats beside the relative 1e-9
    _check(mine[1].extra, ref[1].extra, f"{method} extra", atol=1e-12)
    np.testing.assert_array_equal(n(mine[1].accept),
                                  np.asarray(ref[1].accept))
    if method == "cg":
        assert (n(mine[1].extra) > 0).all()
    if method == "rjpo loose":
        assert 0.0 in n(mine[1].accept)


def test_pcn_exact_log_ratio_equals_the_jax_form(models):
    """pcn_log_ratio: the exact form (one synthesis of the move) and the
    JAX package's difference of totals agree in float64, on the cut and
    the full-grid models."""
    for name in ("band", "full grid"):
        jm, tm, fields = models(name)
        var, s_old, _ = _inputs(jm, fields, 3)
        s = t64(s_old * (var > 0))
        s_prop = t64(0.9 * s_old * (var > 0))
        exact = tcr.pcn_log_ratio(tm, s, s_prop)
        _check(exact, n(tcr.pcn_log_ratio(tm, s, s_prop, exact=False)),
               f"{name} pCN log-ratio", rtol=1e-8)


@pytest.mark.parametrize("method", ["cg", "rjpo", "pcn"])
def test_centered_steps_match_jax(models, method):
    """Two CenteredGibbs iterations with cr_method cg / rjpo / pcn (JAX's
    defaults: cg_tol 1e-6 and 1e-5, beta 0.1) on the band cut model: the
    JAX scheme's vmapped step and the port's batched step on the same
    pools, accept uniforms and gamma variates agree at every iteration."""
    jm, tm, fields = models("band")
    bins = [BINS, BINS]
    jsch = JaxCentered(jm, bins, cr_method=method)
    tsch = CenteredGibbs(tm, bins, cr_method=method)
    assert set(tsch.draw_noise_pool(NCH, torch.Generator())) == (
        {"state"} if method == "pcn" else {"state", "pix"})
    jstep = jax.jit(jax.vmap(jsch.step))
    dl0 = [np.array([f[lo:hi].mean() for lo, hi in zip(BINS[:-1], BINS[1:])])
           for f in fields]
    dls = tuple(np.tile(d, (NCH, 1)) for d in dl0)
    var = np.asarray(jax.vmap(jsch.var_cls)(tuple(jnp.asarray(d)
                                                  for d in dls)))
    s0 = np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(jnp.asarray(d)
                                                  for d in dls))
    tstate = state_from_numpy(s0, dls, device="cpu")
    ell = jnp.arange(jm.lmax + 1, dtype=jnp.float64)
    alpha = jax_bin_sum(2.0 * ell + 1.0, BINS, jm.lmax) / 2.0 - 1.0
    alpha = jnp.where(alpha <= 0, 1.0, alpha)
    rng = np.random.default_rng(1)
    for it in range(2):
        pool = {"state": rng.normal(size=(NCH, 1, 2, tm.nstate))}
        if method != "pcn":
            pool["pix"] = rng.normal(size=(NCH, 1) + tuple(jm.noise.tau.shape))
        keys = jax.random.split(jax.random.PRNGKey(300 + it), NCH)
        jstate, jinfo = jstep(keys, jstate,
                              {k: jnp.asarray(v) for k, v in pool.items()})
        # step(key): k1 -> the CR step (its accept uniform), k2 -> gammas
        u, gam = [], [[], []]
        for key in keys:
            k1, k2 = jax.random.split(key)
            u.append(float(jax.random.uniform(jax.random.split(k1)[1],
                                              dtype=jnp.float64)))
            for f, kf in enumerate(jax.random.split(k2, 2)):
                gam[f].append(np.asarray(jax.random.gamma(kf, alpha)))
        tstate, tinfo = tsch.step(
            tstate, noise={k: t64(v) for k, v in pool.items()}, u=t64(u),
            gammas=tuple(t64(g) for g in gam))
        _check(tstate.s, jstate.s, f"iteration {it} s")
        for f in range(2):
            _check(tstate.dl[f], jstate.dl[f], f"iteration {it} dl[{f}]")
        np.testing.assert_array_equal(n(tinfo["cr_accept"]),
                                      np.asarray(jinfo["cr_accept"]))


def test_cr_methods_and_unknown_name(models):
    """CR_METHODS is the JAX package's tuple, in its order; every name
    builds a scheme; an unknown one raises ValueError."""
    from gibbssampler_tpu.schemes import CR_METHODS as JAX_METHODS
    assert CR_METHODS == JAX_METHODS
    _, tm, _ = models("band")
    for method in CR_METHODS:
        CenteredGibbs(tm, [BINS, BINS], cr_method=method)
    with pytest.raises(ValueError):
        CenteredGibbs(tm, [BINS, BINS], cr_method="gibbs")


# ---------------------------------------------------------------------------
# statistical mirrors (all chains in one call)
# ---------------------------------------------------------------------------

def _exact_draws(tm, var, nch, seed):
    """Exact draws of the masked CR conditional from a dense Cholesky
    factor of Q (columns from the port's q_apply)."""
    Q, act, _ = _dense_q(tm, var)
    bt = n(tm.bt_ninv_d()).reshape(-1)[act]
    chol = np.linalg.cholesky(0.5 * (Q + Q.T))
    mean = np.linalg.solve(Q, bt)
    z = np.random.default_rng(seed).normal(size=(act.size, nch))
    out = np.zeros((nch,) + var.shape)
    out.reshape(nch, -1)[:, act] = (mean[:, None]
                                    + np.linalg.solve(chol.T, z)).T
    return out


def test_cg_cr_matches_exact_distribution():
    """Mirrors tests/test_ops_samplers.py::test_cg_cr_matches_exact_
    distribution: on the full sky, 800 CG draws (tol 1e-10) and 800 exact
    draws have the same means and variances."""
    lmax = 8
    _, tm, fields = _full_grid_model(0, lmax)
    var = t64(_chain_vars(fields, lmax, 0, nch=1)[0])
    bt = tm.bt_ninv_d()
    gen = torch.Generator().manual_seed(4)
    d_exact = n(tcr.exact_cr(tm, var.expand(800, -1, -1), bt, gen=gen)[0])
    d_cg = n(tcr.cg_cr(tm, var.expand(800, -1, -1), bt, tol=1e-10,
                       gen=gen)[0])
    m1, m2 = d_exact.mean(0), d_cg.mean(0)
    v1, v2 = d_exact.var(0), d_cg.var(0)
    scale = float(np.sqrt(v1).max())
    np.testing.assert_allclose(m2[0, 2:40], m1[0, 2:40],
                               atol=5 * scale / np.sqrt(800))
    np.testing.assert_allclose(v2[0, 2:40], v1[0, 2:40], rtol=0.4)


def _masked_spin0(sigma2=1.0):
    lmax = 8
    _, tm, fields = _full_grid_model(0, lmax, sigma2=sigma2,
                                     mask=_ring_mask(lmax))
    return tm, t64(_chain_vars(fields, lmax, 0, nch=1)[0])


def test_rjpo_accepts_with_tight_solver():
    """Mirrors ::test_rjpo_accepts_with_tight_solver: at tol 1e-11 the RJPO
    residual vanishes and all 16 chains accept."""
    tm, var = _masked_spin0()
    bt = tm.bt_ninv_d()
    gen = torch.Generator().manual_seed(0)
    s0 = tcr.exact_cr(tm, var, bt, gen=gen)[0]
    _, info = tcr.rjpo_cr(tm, var.expand(16, -1, -1), bt,
                          s0.expand(16, -1, -1), tol=1e-11, gen=gen)
    assert float(info.accept.mean()) == 1.0


def test_rjpo_loose_solver_correction_is_active():
    """Mirrors ::test_rjpo_loose_solver_correction_is_active: at maxiter 10
    the -s_old start makes the residual correction active (median
    log-ratio < -1, some rejections), and rejected chains stay put."""
    tm, var = _masked_spin0()
    bt = tm.bt_ninv_d()
    nch = 64
    gen = torch.Generator().manual_seed(8)
    v = var.expand(nch, -1, -1)
    ref = tcr.cg_cr(tm, v, bt, tol=1e-10, gen=gen)[0]
    moved, info = tcr.rjpo_cr(tm, v, bt, ref, tol=0.0, maxiter=10, gen=gen)
    assert float(info.extra.median()) < -1.0
    rej = n(info.accept) == 0.0
    assert rej.any()
    np.testing.assert_array_equal(n(moved)[rej], n(ref)[rej])


def test_pcn_acceptance_and_invariance():
    """Mirrors ::test_pcn_acceptance_and_invariance on a weak likelihood
    (sigma2 5e4): started from exact draws, pCN at beta 0.05 accepts more
    than 20% and keeps the posterior mean."""
    tm, var = _masked_spin0(sigma2=5e4)
    nch = 400
    ref = _exact_draws(tm, n(var), nch, 20)
    gen = torch.Generator().manual_seed(21)
    moved, info = tcr.pcn_cr(tm, var.expand(nch, -1, -1), tm.bt_ninv_d(),
                             t64(ref), beta=0.05, gen=gen)
    assert float(info.accept.mean()) > 0.2
    m_ref, m_new = ref.mean(0), n(moved).mean(0)
    scale = float(np.sqrt(ref.var(0)).max())
    np.testing.assert_allclose(m_new[0, 2:40], m_ref[0, 2:40],
                               atol=6 * scale / np.sqrt(nch))


def test_cg_cut_matches_full_path(models):
    """Mirrors tests/test_cut.py::test_cg_cut_matches_full_path: the same
    pools through cg_cr on the full-grid model and on its cut
    decomposition give the same draw (tol 1e-11)."""
    jm, tm, fields = models("full grid")
    tc = port_model(jm, cut=True)
    var, _, pool = _inputs(jm, fields, 5)
    tpool = {k: t64(v) for k, v in pool.items()}
    s1 = tcr.cg_cr(tm, t64(var), tm.bt_ninv_d(), tol=1e-11, maxiter=1500,
                   noise=tpool)[0]
    s2 = tcr.cg_cr(tc, t64(var), tc.bt_ninv_d(), tol=1e-11, maxiter=1500,
                   noise=tpool)[0]
    np.testing.assert_allclose(n(s2), n(s1), atol=1e-7, rtol=1e-6)
