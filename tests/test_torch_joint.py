"""The port's joint TQU family against the JAX package's, float64 on the
CPU: the spin-3 SkyModel's operators (full grid, band cut, floor +
sparse-hole split), the joint CR draws (exact and CG), the inverse-Wishart
draw, synfast_joint and one JointCenteredGibbs step, each on the variates
JAX draws from its keys (in its split order), to 1e-9 relative; then
statistical mirrors of tests/test_joint.py and the spin-3 simulation of
tests/test_misc.py with the port's own generators."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import holey_mask, jax_model_arrays, n, t64
from gibbssampler_tpu.inference import example_dl as jax_example_dl
from gibbssampler_tpu.inference import simulate_dataset as jax_simulate
from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
from gibbssampler_tpu.samplers import joint as jj
from gibbssampler_tpu.samplers.cls_samplers import (
    invwishart_cls_sample as jax_invwishart)
from gibbssampler_tpu.schemes import JointCenteredGibbs as JaxJoint
from gibbssampler_tpu.schemes.joint_scheme import JointState as JaxJointState
from gibbssampler_tpu.sht import gauss_legendre_grid
from gibbssampler_tpu_torch.harmonics import (alm2cl_state, ell_mask_state,
                                              state_masks)
from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
from gibbssampler_tpu_torch.interop import model_from_numpy, state_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.samplers import (cg_joint_cr, exact_joint_cr,
                                             expand_cl_blocks,
                                             invwishart_cls_sample,
                                             joint_block_ops, synfast_joint)
from gibbssampler_tpu_torch.schemes import JointCenteredGibbs

LMAX = 10
K = 3
NCH = 3
RTOL = 1e-9


def theory_blocks(lmax=LMAX, r_te=0.6):
    """SPD C_ell blocks with TE correlation r_te (tests/test_joint.py)."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    tt = 10.0 / (1.0 + ell) ** 1.5
    ee = 0.5 / (1.0 + ell) ** 1.5
    bb = 0.05 / (1.0 + ell) ** 1.5
    C = np.zeros((lmax + 1, K, K))
    C[:, 0, 0], C[:, 1, 1], C[:, 2, 2] = tt, ee, bb
    C[:, 0, 1] = C[:, 1, 0] = r_te * np.sqrt(tt * ee)
    C[:2] = 0.0
    return C


def chain_blocks(nch=NCH, seed=0):
    """(nch, L, K, K) SPD blocks, a different TE correlation per chain."""
    return np.stack([theory_blocks(r_te=r)
                     for r in np.linspace(-0.5, 0.7, nch)])


def jax_spin3(kind, sigma2=0.5):
    """A JAX spin-3 dataset on the GL grid (lmax 10): full sky, a band
    cut (the plain model and its cut decomposition) or a holey mask (its
    floor + sparse-hole split)."""
    grid = gauss_legendre_grid(LMAX)
    mask = None
    if kind == "band":
        keep = (np.abs(np.pi / 2 - grid.theta) > 0.3).astype(np.float64)
        mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    elif kind == "holey":
        mask = holey_mask(grid)
    fields = np.stack([jax_example_dl(LMAX, k, amp=10.0)
                       for k in ("tt", "ee", "bb")])
    model, _ = jax_simulate(jax.random.PRNGKey(0), LMAX, spin=3,
                            dl_fields=fields, noise_sigma2=sigma2,
                            fwhm_radians=0.05, mask=mask, dtype=jnp.float64)
    if kind == "full":
        return model, model
    return model, jax_cut(model, sparse_split=(kind == "holey"))


def port_of(jmodel, cut_kind):
    m = model_from_numpy(jax_model_arrays(jmodel), device="cpu")
    if cut_kind == "full":
        return m
    return with_cut_decomposition(m, sparse_split=(cut_kind == "holey"))


def close(a, b, rtol=RTOL):
    a, b = n(a), np.asarray(b)
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= rtol * scale, (np.abs(a - b).max(), scale)


@pytest.fixture(scope="module", params=["full", "band", "holey"])
def models(request):
    plain, jm = jax_spin3(request.param)
    return request.param, plain, jm, port_of(plain, request.param)


def test_spin3_model_operators_match_jax(models):
    """Synthesis, adjoint, the harmonic noise diagonal and qn_apply (the
    cut-ring complement form on the cut models), for a batch of states."""
    kind, _, jm, tm = models
    assert tm.nfields == 3 and tm.has_cut == (kind != "full")
    assert tm.has_sparse == (kind == "holey")
    rng = np.random.default_rng(1)
    s = rng.normal(size=(2, K, tm.nstate)) * ell_mask_state(LMAX, 0)
    f = rng.normal(size=(2,) + tuple(tm.noise.tau.shape))
    close(tm.synthesis(t64(s)), jax.vmap(jm.synthesis)(jnp.asarray(s)))
    close(tm.adjoint_synthesis(t64(f)),
          jax.vmap(jm.adjoint_synthesis)(jnp.asarray(f)))
    close(tm.harmonic_noise_diag(), jm.harmonic_noise_diag())
    close(tm.qn_apply(t64(s)), jax.vmap(jm.qn_apply)(jnp.asarray(s)))
    if kind != "full":
        au_c, au_s = tm.synthesis_cut_sp(t64(s))
        ju_c, ju_s = jax.vmap(jm.synthesis_cut_sp)(jnp.asarray(s))
        close(au_c, ju_c)
        if kind == "holey":
            close(au_s, ju_s)
            back = tm.adjoint_cut_sp(au_c, au_s)
            close(back, jax.vmap(jm.adjoint_cut_sp)(ju_c, ju_s))
        # the cut data terms of the complement identity
        close(tm.cut_c1, jm.cut_c1)
        close(tm.w_cut, jm.w_cut)


def test_expand_cl_blocks_matches_jax():
    C = theory_blocks()
    close(expand_cl_blocks(t64(C), LMAX), jj.expand_cl_blocks(
        jnp.asarray(C), LMAX))


def _jax_xi(keys, nst):
    """The xi of JAX's _slot_chol_sample / synfast_joint per key, as the
    port takes it: (nchains, K, nstate)."""
    return np.stack([np.asarray(jax.random.normal(k, (nst, K, 1),
                                                  dtype=jnp.float64))[..., 0].T
                     for k in keys])


def test_exact_joint_cr_matches_jax(models):
    kind, _, jm, tm = models
    C = chain_blocks()
    keys = jax.random.split(jax.random.PRNGKey(3), NCH)
    bt = jm.bt_ninv_d()
    ref = jax.vmap(lambda k, c: jj.exact_joint_cr(k, jm, c, bt)[0])(
        keys, jnp.asarray(C))
    tbt = tm.bt_ninv_d()
    close(tbt, bt)
    s, info = exact_joint_cr(tm, t64(C), tbt, xi=t64(_jax_xi(keys,
                                                             tm.nstate)))
    close(s, ref)
    assert info.accept.shape == (NCH,) and (n(info.accept) == 1).all()


def _jax_om(keys, bt_shape, tau_shape):
    """om0, om1 of JAX's cg_joint_cr per key (k0, k1 = split(key))."""
    om0, om1 = [], []
    for k in keys:
        k0, k1 = jax.random.split(k)
        om0.append(np.asarray(jax.random.normal(k0, bt_shape,
                                                dtype=jnp.float64)))
        om1.append(np.asarray(jax.random.normal(k1, tau_shape,
                                                dtype=jnp.float64)))
    return np.stack(om0), np.stack(om1)


def test_cg_joint_cr_matches_jax(models):
    """cg_joint_cr at tol 1e-12 on the full sky and on the cut models (the
    qn_apply of the complement decomposition), per chain, against JAX's
    draw from the same variates; the iterations per chain equal."""
    kind, _, jm, tm = models
    C = chain_blocks()
    keys = jax.random.split(jax.random.PRNGKey(4), NCH)
    bt = jm.bt_ninv_d()
    ref, rinfo = jax.vmap(lambda k, c: jj.cg_joint_cr(
        k, jm, c, bt, tol=1e-12, maxiter=2000))(keys, jnp.asarray(C))
    om0, om1 = _jax_om(keys, bt.shape, jm.noise.tau.shape)
    s, info = cg_joint_cr(tm, t64(C), tm.bt_ninv_d(), tol=1e-12,
                          maxiter=2000, om0=t64(om0), om1=t64(om1))
    close(s, ref)
    np.testing.assert_array_equal(n(info.extra), np.asarray(rinfo.extra))


def test_joint_cg_on_cut_model_matches_plain():
    """The cut model's CG draw equals the plain model's on the same
    variates (qn_apply's complement form is exact on the GL grid), as
    tests/test_cut.py::test_joint_cg_on_cut_model."""
    plain, jm = jax_spin3("band")
    tp, tc = port_of(plain, "full"), port_of(plain, "band")
    C = t64(chain_blocks(2))
    gen = torch.Generator().manual_seed(5)
    om0 = torch.randn((2, K, tp.nstate), generator=gen, dtype=torch.float64)
    om1 = torch.randn((2,) + tuple(tp.noise.tau.shape), generator=gen,
                      dtype=torch.float64)
    bt = tp.bt_ninv_d()
    s1, _ = cg_joint_cr(tp, C, bt, tol=1e-11, maxiter=1500, om0=om0, om1=om1)
    s2, _ = cg_joint_cr(tc, C, bt, tol=1e-11, maxiter=1500, om0=om0, om1=om1)
    np.testing.assert_allclose(n(s2), n(s1), atol=1e-7, rtol=1e-6)


def _jax_iw_variates(keys):
    """JAX's invwishart draws per key: kchi, knorm = split(key); chi2 =
    2 gamma(kchi, df / 2); normals = normal(knorm, (L, K, K))."""
    nu = 2.0 * jnp.arange(LMAX + 1, dtype=jnp.float64) + 1.0
    df = jnp.maximum(nu[:, None] - jnp.arange(K, dtype=jnp.float64)[None],
                     1e-3)
    chi2, normals = [], []
    for k in keys:
        kchi, knorm = jax.random.split(k)
        chi2.append(np.asarray(2.0 * jax.random.gamma(kchi, df / 2.0)))
        normals.append(np.asarray(jax.random.normal(
            knorm, (LMAX + 1, K, K), dtype=jnp.float64)))
    return np.stack(chi2), np.stack(normals)


def test_invwishart_matches_jax():
    C = theory_blocks()
    s = np.stack([np.asarray(jj.synfast_joint(k, C, LMAX, dtype=jnp.float64))
                  for k in jax.random.split(jax.random.PRNGKey(6), NCH)])
    keys = jax.random.split(jax.random.PRNGKey(7), NCH)
    ref = jax.vmap(lambda k, x: jax_invwishart(k, x, LMAX))(
        keys, jnp.asarray(s))
    chi2, normals = _jax_iw_variates(keys)
    out = invwishart_cls_sample(t64(s), LMAX, chi2=t64(chi2),
                                normals=t64(normals))
    close(out, ref)
    assert (n(out)[:, :2] == 0).all()


def test_synfast_joint_matches_jax():
    C = chain_blocks()
    keys = jax.random.split(jax.random.PRNGKey(8), NCH)
    ref = jax.vmap(lambda k, c: jj.synfast_joint(k, c, LMAX,
                                                 dtype=jnp.float64))(
        keys, jnp.asarray(C))
    nst = 2 * (LMAX + 1) ** 2
    out = synfast_joint(t64(C), LMAX, dtype=torch.float64, device="cpu",
                        xi=t64(_jax_xi(keys, nst)))
    close(out, ref)


@pytest.mark.parametrize("cr", ["exact", "cg"])
def test_joint_step_matches_jax(cr):
    """One JointCenteredGibbs.step of NCH chains on the band model (CG
    through the cut decomposition), JAX's vmapped step against the port's
    on the variates of each chain's key: k1, k2 = split(key) for the CR and
    the inverse-Wishart draw."""
    plain, jm = jax_spin3("band")
    tm = port_of(plain, "band")
    opts = {"cg_tol": 1e-12, "cg_maxiter": 2000}
    jsch = JaxJoint(jm, cr_method=cr, cr_options=opts)
    tsch = JointCenteredGibbs(tm, cr_method=cr, cr_options=opts)
    C = chain_blocks()
    rng = np.random.default_rng(2)
    s0 = rng.normal(size=(NCH, K, tm.nstate)) * ell_mask_state(LMAX)
    keys = jax.random.split(jax.random.PRNGKey(9), NCH)
    (jst, jinfo) = jax.vmap(jsch.step)(
        keys, JaxJointState(s=jnp.asarray(s0), cl=jnp.asarray(C)))
    k1k2 = [jax.random.split(k) for k in keys]
    bt_shape = (K, tm.nstate)
    if cr == "exact":
        noise = {"xi": t64(_jax_xi([k[0] for k in k1k2], tm.nstate))}
    else:
        om0, om1 = _jax_om([k[0] for k in k1k2], bt_shape,
                           jm.noise.tau.shape)
        noise = {"om0": t64(om0), "om1": t64(om1)}
    chi2, normals = _jax_iw_variates([k[1] for k in k1k2])
    state = state_from_numpy(s0, cl=C, device="cpu")
    tst, tinfo = tsch.step(state, noise=noise, chi2=t64(chi2),
                           normals=t64(normals))
    close(tst.s, jst.s)
    close(tst.cl, jst.cl)
    close(tinfo["dl"][0], jinfo["dl"][0])
    np.testing.assert_array_equal(n(tinfo["cr_accept"]),
                                  np.asarray(jinfo["cr_accept"]))


def test_joint_run_shapes_and_check():
    """run() end to end on the port's generator, and check_cl_init's
    refusal of a non-SPD block."""
    plain, _ = jax_spin3("full")
    sch = JointCenteredGibbs(port_of(plain, "full"))
    C = theory_blocks()
    out = sch.run(C, n_iter=4, nchains=2,
                  gen=torch.Generator().manual_seed(0))
    assert out["dl_chains"][0].shape == (2, 4, LMAX + 1, K, K)
    assert out["cr_accept"].shape == (2, 4)
    assert np.isfinite(n(out["dl_chains"][0])).all()
    bad = C.copy()
    bad[5, 0, 1] = bad[5, 1, 0] = 2.0 * np.sqrt(C[5, 0, 0] * C[5, 1, 1])
    with pytest.raises(ValueError, match="positive-semidefinite"):
        sch.check_cl_init(bad)
    with pytest.raises(ValueError, match="exact|cg"):
        JointCenteredGibbs(sch.model, cr_method="aux_gibbs")


# ---- statistical mirrors (the port's own generators) ---------------------

def _port_joint_model(noise_sigma2, seed=0):
    """tests/test_joint.py::make_joint_model on the port: synfast_joint
    truth, full-sky white noise."""
    from gibbssampler_tpu_torch.ops import NoiseModel, SkyModel
    from gibbssampler_tpu_torch.sht import make_sht
    gen = torch.Generator().manual_seed(seed)
    sht = make_sht(LMAX, dtype=torch.float64, spin2=True, device="cpu")
    C = theory_blocks()
    s_true = synfast_joint(C, LMAX, dtype=torch.float64, device="cpu",
                           gen=gen)
    noise = NoiseModel.white(noise_sigma2, sht.grid, nfields=K,
                             dtype=torch.float64, device="cpu")
    bl = torch.ones(LMAX + 1, dtype=torch.float64)
    model = SkyModel(sht=sht, noise=noise, bl=bl, spin=3)
    sky = model.synthesis(s_true)
    d = sky + torch.randn(sky.shape, generator=gen, dtype=torch.float64) \
        / torch.sqrt(noise.inv_noise)
    return SkyModel(sht=sht, noise=noise, bl=bl, spin=3, d=d), C, s_true


def test_synfast_joint_covariance():
    C = theory_blocks()
    draws = synfast_joint(np.tile(C, (600, 1, 1, 1)), LMAX,
                          dtype=torch.float64, device="cpu",
                          gen=torch.Generator().manual_seed(2))
    tt = n(alm2cl_state(draws[:, 0], LMAX)).mean(0)
    te = n(alm2cl_state(draws[:, 0], LMAX, draws[:, 1])).mean(0)
    np.testing.assert_allclose(tt[2:], C[2:, 0, 0], rtol=0.15)
    np.testing.assert_allclose(te[2:], C[2:, 0, 1], rtol=0.25)


def test_exact_joint_cr_moments():
    model, C, _ = _port_joint_model(0.5)
    bt = model.bt_ninv_d()
    nd = 1500
    draws = n(exact_joint_cr(model, t64(np.broadcast_to(C, (nd,) + C.shape)),
                             bt, gen=torch.Generator().manual_seed(3))[0])
    cov = n(expand_cl_blocks(t64(C), LMAX))
    g = n(model.harmonic_noise_diag())
    slots = np.where(ell_mask_state(LMAX, lmin=2) > 0)[0]
    bt_np = n(bt)
    for slot in [slots[2], slots[30], slots[77]]:
        Sig = np.linalg.inv(np.linalg.inv(cov[slot]) + np.diag(g[:, slot]))
        mean = Sig @ bt_np[:, slot]
        se = np.sqrt(np.diag(Sig) / nd)
        np.testing.assert_allclose(draws[:, :, slot].mean(0), mean,
                                   atol=6 * se.max())
        np.testing.assert_allclose(np.diag(np.cov(draws[:, :, slot].T)),
                                   np.diag(Sig), rtol=0.3)


def test_cg_joint_cr_moments_full_sky():
    """The CG draw's moments on the full sky match the exact posterior
    (tests/test_joint.py::test_joint_scheme_cg_masked_runs, second half)."""
    model, C, _ = _port_joint_model(0.5)
    bt = model.bt_ninv_d()
    nd = 800
    draws = n(cg_joint_cr(model, t64(np.broadcast_to(C, (nd,) + C.shape)),
                          bt, tol=1e-9,
                          gen=torch.Generator().manual_seed(12))[0])
    cov = n(expand_cl_blocks(t64(C), LMAX))
    g = n(model.harmonic_noise_diag())
    slot = np.where(ell_mask_state(LMAX, lmin=2) > 0)[0][25]
    Sig = np.linalg.inv(np.linalg.inv(cov[slot]) + np.diag(g[:, slot]))
    mean = Sig @ n(bt)[:, slot]
    se = np.sqrt(np.diag(Sig) / nd)
    np.testing.assert_allclose(draws[:, :, slot].mean(0), mean,
                               atol=6 * se.max())
    np.testing.assert_allclose(draws[:, :, slot].var(0), np.diag(Sig),
                               rtol=0.35)


def test_joint_block_ops_against_dense():
    """The block operators: C^-1 and its root per slot, against numpy."""
    model, C, _ = _port_joint_model(0.5)
    apply_cinv, apply_sqrt, _, active = joint_block_ops(model, t64(C))
    cov = n(expand_cl_blocks(t64(C), LMAX))
    slot = np.where(n(active) > 0)[0][40]
    cinv = np.linalg.inv(cov[slot])
    xi = np.random.default_rng(0).normal(size=(K, model.nstate))
    np.testing.assert_allclose(n(apply_cinv(t64(xi)))[:, slot],
                               cinv @ xi[:, slot], rtol=1e-10)
    np.testing.assert_allclose(n(apply_sqrt(t64(xi)))[:, slot],
                               np.linalg.cholesky(cinv) @ xi[:, slot],
                               rtol=1e-10)
    assert (n(apply_cinv(t64(xi)))[:, n(active) == 0] == 0).all()


def test_invwishart_conjugacy():
    """E[C | s] = S_l / (nu - k - 1) for InvWishart(nu = 2l+1, S_l)."""
    C = theory_blocks()
    s = synfast_joint(C, LMAX, dtype=torch.float64, device="cpu",
                      gen=torch.Generator().manual_seed(4))
    draws = invwishart_cls_sample(s.expand(3000, -1, -1), LMAX,
                                  gen=torch.Generator().manual_seed(5))
    mean_draws = n(draws).mean(axis=0)
    l = 8
    L = LMAX + 1
    ell_state = np.broadcast_to(np.arange(L), (2, L, L)).reshape(-1)
    slots = np.where((ell_state == l)
                     & (state_masks(LMAX).valid.reshape(-1) > 0))[0]
    s_np = n(s)
    S = sum(np.outer(s_np[:, i], s_np[:, i]) for i in slots)
    np.testing.assert_allclose(mean_draws[l], S / (2 * l + 1 - K - 1),
                               rtol=0.2)


def test_joint_gibbs_recovers_te_correlation():
    """The posterior TE correlation tracks the realization's at high SNR
    (tests/test_joint.py::test_joint_gibbs_recovers_te_correlation)."""
    model, C, s_true = _port_joint_model(1e-4)
    out = JointCenteredGibbs(model).run(
        C, n_iter=400, nchains=4, gen=torch.Generator().manual_seed(6))
    post = n(out["dl_chains"][0])[:, 100:].mean(axis=(0, 1))
    tt_hat = n(alm2cl_state(s_true[0], LMAX))
    ee_hat = n(alm2cl_state(s_true[1], LMAX))
    te_hat = n(alm2cl_state(s_true[0], LMAX, s_true[1]))
    fac = np.arange(LMAX + 1) * (np.arange(LMAX + 1) + 1.0) / (2 * np.pi)
    for l in range(4, LMAX + 1):
        iw_fac = (2 * l + 1.0) / (2 * l - 3.0)
        assert np.isclose(post[l, 0, 0], tt_hat[l] * fac[l] * iw_fac,
                          rtol=0.4), l
        r_post = post[l, 0, 1] / np.sqrt(post[l, 0, 0] * post[l, 1, 1])
        r_hat = te_hat[l] / np.sqrt(tt_hat[l] * ee_hat[l])
        assert abs(r_post - r_hat) < 0.45, (l, r_post, r_hat)


def test_simulate_spin3():
    """tests/test_misc.py::test_simulate_spin3 on the port, with the
    correlated draw too: the TQU operator is its own adjoint's transpose,
    and the truth keeps the blocks."""
    lmax = 8
    fields = np.stack([example_dl(lmax, k) for k in ("tt", "ee", "bb")])
    blocks = np.zeros((lmax + 1, 3, 3))
    for f in range(3):
        blocks[:, f, f] = fields[f]
    blocks[:, 0, 1] = blocks[:, 1, 0] = 0.5 * np.sqrt(fields[0] * fields[1])
    for dlb in (None, blocks):
        model, truth = simulate_dataset(
            lmax, 3, fields, 1.0, dtype=torch.float64, device="cpu",
            gen=torch.Generator().manual_seed(1), dl_blocks=dlb)
        assert model.d.shape[0] == 3 and model.nfields == 3
        s = truth["alm_true"]
        f = model.synthesis(s)
        lhs = float((f * f).sum())
        rhs = float((s * model.adjoint_synthesis(f)).sum())
        assert abs(lhs - rhs) < 1e-9 * abs(lhs)
        assert ("dl_blocks_true" in truth) == (dlb is not None)
