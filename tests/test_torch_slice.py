"""The port's centered masked-polarization slice as a whole: several
iterations against the JAX scheme on the same injected variates, and the
user entry points end to end (float64, CPU, small lmax)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from torch_parity import make_masked, n, port_model, t64
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.schemes import CenteredGibbs as JaxCentered
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
from gibbssampler_tpu_torch.interop import state_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.schemes import CenteredGibbs
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

LMAX = 8
NCH = 4
NITER = 3
BINS = np.array([2, 4, 6, 9])
OPTS = {"n_gibbs": 1, "tau": 0.02}


def test_slice_matches_jax_over_iterations():
    """NITER centered aux_mala iterations of NCH chains: the JAX scheme's
    vmapped step and the port's batched step, fed the same pools, MALA
    uniforms and gamma variates, agree to rtol 1e-9 at every iteration
    (state, D_ell and accepts)."""
    _, mc, fields = make_masked(spin=2, sigma2=0.5, lmax=LMAX)
    tc = port_model(mc, cut=True)
    jsch = JaxCentered(mc, [BINS, BINS], cr_method="aux_mala",
                       cr_options=OPTS)
    tsch = CenteredGibbs(tc, [BINS, BINS], cr_method="aux_mala",
                         cr_options=OPTS)
    jstep = jax.jit(jax.vmap(jsch.step))
    dl0 = tuple(np.tile([f[lo:hi].mean() for lo, hi in zip(BINS[:-1],
                                                           BINS[1:])],
                        (NCH, 1)) for f in fields)
    var = np.asarray(jax.vmap(jsch.var_cls)(tuple(jnp.asarray(d)
                                                  for d in dl0)))
    s0 = np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(jnp.asarray(d)
                                                  for d in dl0))
    tstate = state_from_numpy(s0, dl0, device="cpu")
    ell = jnp.arange(LMAX + 1, dtype=jnp.float64)
    alpha = jax_bin_sum(2.0 * ell + 1.0, BINS, LMAX) / 2.0 - 1.0
    alpha = jnp.where(alpha <= 0, 1.0, alpha)
    rng = np.random.default_rng(1)
    for it in range(NITER):
        pool = {"state": rng.normal(size=(NCH, 2, 2, tc.nstate)),
                "aux": rng.normal(size=(NCH, 1) + tuple(tc.w_cut.shape))}
        keys = jax.random.split(jax.random.PRNGKey(100 + it), NCH)
        jstate, jinfo = jstep(keys, jstate,
                              {k: jnp.asarray(v) for k, v in pool.items()})
        # step(key): k1 -> aux_then_mala_cr -> split -> mala_cr(k2) ->
        # split -> uniform(ka); k2 -> split(k2, 2) -> gamma per field
        u, gam = [], [[], []]
        for key in keys:
            k1, k2 = jax.random.split(key)
            ka = jax.random.split(jax.random.split(k1)[1])[1]
            u.append(float(jax.random.uniform(ka, dtype=jnp.float64)))
            for f, kf in enumerate(jax.random.split(k2, 2)):
                gam[f].append(np.asarray(jax.random.gamma(kf, alpha)))
        tstate, tinfo = tsch.step(tstate,
                                  noise={k: t64(v) for k, v in pool.items()},
                                  u=t64(u), gammas=tuple(t64(g) for g in gam))
        for mine, ref in [(tstate.s, jstate.s), (tstate.dl[0], jstate.dl[0]),
                          (tstate.dl[1], jstate.dl[1])]:
            ref = np.asarray(ref)
            np.testing.assert_allclose(n(mine), ref, rtol=1e-9,
                                       atol=1e-9 * float(np.abs(ref).max()),
                                       err_msg=f"iteration {it}")
        np.testing.assert_array_equal(n(tinfo["cr_accept"]),
                                      np.asarray(jinfo["cr_accept"]))


def test_slice_runs_end_to_end():
    """simulate -> cut decomposition -> CenteredGibbs.run with the port's
    own generator; on the CPU no kernel is launched (plain versions)."""
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
    assert 0 < model.cut_sht.nrings < nr
    bins = np.array([2, 5, 9, 13])
    dl0 = tuple(np.array([d[lo:hi].mean() for lo, hi in zip(bins[:-1],
                                                             bins[1:])])
                for d in dls)
    scheme = CenteredGibbs(model, [bins, bins], cr_method="aux_mala",
                           cr_options=OPTS)
    lk.reset_launch_counts()
    out = scheme.run(dl0, n_iter=6, nchains=3, gen=gen)
    for f in range(2):
        dl = n(out["dl_chains"][f])
        assert dl.shape == (3, 6, 3)
        assert np.isfinite(dl).all() and (dl > 0).all()
    acc = n(out["cr_accept"])
    assert acc.shape == (3, 6) and set(np.unique(acc)) <= {0.0, 1.0}
    assert acc.mean() > 0.0
    assert (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches) \
        == (0, 0)
