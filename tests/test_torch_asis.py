"""The port's ASIS scheme as a whole: three iterations against the JAX
scheme's vmapped step on the same injected variates, the table engine
against the direct MH path at the scheme level, and ``ASISGibbs.run`` end
to end on the port's own generator (float64, CPU, small lmax)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_mh_uniforms, make_masked, n, port_model, t64)
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.samplers import cls_samplers as jcs
from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
from gibbssampler_tpu_torch.interop import state_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.schemes import ASISGibbs
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

LMAX = 12
NCH = 4
NITER = 3
OPTS = {"n_gibbs": 1, "tau": 0.02}
# the main path's shape: EE unit bins in one block; BB unit then wide bins,
# a big block followed by single-bin blocks
BINS = [np.arange(2, LMAX + 2), np.array([2, 3, 4, 5, 6, 7, 8, 10, 11, 13])]
BLOCKS = [[(0, 11)], [(0, 3)] + [(i, i + 1) for i in range(3, 9)]]


def _start(fields):
    dl0 = [np.array([f[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])])
           for f, b in zip(fields, BINS)]
    return dl0, [0.3 * d for d in dl0]


def _alpha(bins):
    ell = jnp.arange(LMAX + 1, dtype=jnp.float64)
    a = jax_bin_sum(2.0 * ell + 1.0, bins, LMAX) / 2.0 - 1.0
    return jnp.where(a <= 0, 1.0, a)


@pytest.fixture(scope="module")
def masked():
    _, mc, fields = make_masked(spin=2, sigma2=0.5, lmax=LMAX)
    return mc, port_model(mc, cut=True), fields


def test_asis_step_matches_jax_over_iterations(masked, monkeypatch):
    """NITER ASIS iterations of NCH chains: the JAX scheme's vmapped step
    and the port's batched step, fed the same pools, MALA uniforms, gamma
    variates, proposal uniforms and block uniforms, agree to rtol 1e-9 at
    every iteration (state and D_ell); the CR and MH accepts are equal.
    Chunks of at most 3 bins in both packages."""
    mc, tc, fields = masked
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    dl0, sig = _start(fields)
    kw = dict(n_iter_mh=1, cr_method="aux_mala", cr_options=OPTS)
    jsch = JaxASIS(mc, BINS, BLOCKS, sig, **kw)
    tsch = ASISGibbs(tc, BINS, BLOCKS, sig, **kw)
    assert jsch._use_cut_mh and tsch._use_cut_mh
    jstep = jax.jit(jax.vmap(jsch.step))
    dls = tuple(np.tile(d, (NCH, 1)) for d in dl0)
    var = np.asarray(jax.vmap(jsch.var_cls)(tuple(jnp.asarray(d)
                                                  for d in dls)))
    s0 = np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(jnp.asarray(d)
                                                  for d in dls))
    tstate = state_from_numpy(s0, dls, device="cpu")
    alphas = [_alpha(b) for b in BINS]
    ntot = sum(len(b) - 1 for b in BINS)
    nblocks = sum(map(len, BLOCKS))
    rng = np.random.default_rng(1)
    mh_acc = []
    for it in range(NITER):
        pool = {"state": rng.normal(size=(NCH, 2, 2, tc.nstate)),
                "aux": rng.normal(size=(NCH, 1) + tuple(tc.w_cut.shape))}
        keys = jax.random.split(jax.random.PRNGKey(100 + it), NCH)
        jstate, jinfo = jstep(keys, jstate,
                              {k: jnp.asarray(v) for k, v in pool.items()})
        # step(key): k1, k2, k3 = split(key, 3); k1 -> aux_then_mala_cr ->
        # split -> mala_cr(k2) -> split -> uniform(ka); k2 -> split(k2, 2)
        # -> gamma per field; k3 -> the MH sweep's uniforms
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
            ref = np.asarray(ref)
            np.testing.assert_allclose(n(mine), ref, rtol=1e-9,
                                       atol=1e-9 * float(np.abs(ref).max()),
                                       err_msg=f"iteration {it} {what}")
        np.testing.assert_array_equal(n(tinfo["cr_accept"]),
                                      np.asarray(jinfo["cr_accept"]))
        for f in range(2):
            np.testing.assert_array_equal(n(tinfo["mh_accept"][f]),
                                          np.asarray(jinfo["mh_accept"][f]))
            mh_acc.append(n(tinfo["mh_accept"][f]).ravel())
    mh_acc = np.concatenate(mh_acc)
    assert 0.0 < mh_acc.mean() < 1.0


def test_asis_table_engine_matches_direct_scheme(masked):
    """ASISGibbs.run with the table engine and with mh_fast="off", both on
    generators of one seed: the same chains (the two engines consume the
    generator alike)."""
    _, tc, fields = masked
    dl0, sig = _start(fields)
    kw = dict(n_iter_mh=2, cr_method="aux_mala", cr_options=OPTS)
    outs = []
    for mh_fast in ("auto", "off"):
        sch = ASISGibbs(tc, BINS, BLOCKS, sig, mh_fast=mh_fast, **kw)
        assert sch._use_cut_mh == (mh_fast == "auto")
        outs.append(sch.run(dl0, n_iter=3, nchains=3,
                            gen=torch.Generator().manual_seed(7)))
    for f in range(2):
        ref = n(outs[1]["dl_chains"][f])
        np.testing.assert_allclose(n(outs[0]["dl_chains"][f]), ref,
                                   rtol=1e-9, atol=1e-9 * np.abs(ref).max())
        np.testing.assert_array_equal(n(outs[0]["mh_accept"][f]),
                                      n(outs[1]["mh_accept"][f]))


def test_asis_runs_end_to_end():
    """simulate -> cut decomposition -> ASISGibbs.run with the port's own
    generator; per-field MH accept histories; on the CPU no kernel is
    launched (plain versions)."""
    lmax = 12
    gen = torch.Generator().manual_seed(0)
    nr = lmax + 1
    theta = np.arccos(np.polynomial.legendre.leggauss(nr)[0][::-1])
    keep = (np.abs(np.pi / 2 - theta) > 0.2).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (nr, 2 * lmax + 2))
    dls = np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")])
    model, _ = simulate_dataset(lmax, 2, dls, 0.2 ** 2,
                                fwhm_radians=np.radians(0.5), mask=mask,
                                dtype=torch.float64, device="cpu", gen=gen)
    model = with_cut_decomposition(model)
    assert model.cut_w_uniform and model.cut_w_equal_fields
    dl0 = [np.array([d[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])])
           for d, b in zip(dls, BINS)]
    sig = [0.2 * d for d in dl0]
    scheme = ASISGibbs(model, BINS, BLOCKS, sig, cr_method="aux_mala",
                       cr_options=OPTS)
    assert scheme._use_cut_mh
    lk.reset_launch_counts()
    out = scheme.run(dl0, n_iter=6, nchains=3, gen=gen)
    for f in range(2):
        dl = n(out["dl_chains"][f])
        assert dl.shape == (3, 6, len(BINS[f]) - 1)
        assert np.isfinite(dl).all() and (dl > 0).all()
        acc = n(out["mh_accept"][f])
        assert acc.shape == (3, 6, len(BLOCKS[f]))
        assert set(np.unique(acc)) <= {0.0, 1.0}
    acc = np.concatenate([n(a).ravel() for a in out["mh_accept"]])
    assert 0.0 < acc.mean() < 1.0
    assert n(out["cr_accept"]).mean() > 0.0
    assert (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches) \
        == (0, 0)
