"""The port's SkyModel and cut-sky complement decomposition against the JAX
model of tests/test_cut.py's make_masked recipe, carried across through
``interop`` (float64, CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from torch_parity import jax_model_arrays, make_masked, n, port_model, t64
from gibbssampler_tpu.harmonics import variance_expansion_state
from gibbssampler_tpu_torch.interop import model_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition

LMAX = 10


def _inv_var(fields):
    var = np.stack([np.asarray(variance_expansion_state(jnp.asarray(f),
                                                        LMAX))
                    for f in fields])
    return np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)


@pytest.mark.parametrize("spin", [0, 2])
def test_cut_decomposition_matches_jax(spin):
    _, mc, _ = make_masked(spin=spin)
    tc = port_model(mc, cut=True)
    assert tc.cut_sht.nrings == mc.cut_sht.nrings
    np.testing.assert_array_equal(tc.cut_sht.grid.theta, mc.cut_sht.grid.theta)
    for name in ("w_cut", "d_cut", "cut_c0", "cut_c1"):
        np.testing.assert_allclose(n(getattr(tc, name)), n(getattr(mc, name)),
                                   rtol=0, atol=1e-12 * max(
                                       1.0, float(np.abs(n(getattr(mc, name)))
                                                  .max())), err_msg=name)
    tables = ("lam0",) + (("lam_p2", "lam_m2") if spin == 2 else ())
    for name in tables:
        np.testing.assert_allclose(n(getattr(tc.cut_sht, name)),
                                   n(getattr(mc.cut_sht, name)[0]),
                                   rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("spin", [0, 2])
def test_q_apply_cut_exact(spin):
    """Mirrors test_cut.py::test_q_apply_cut_exact, with a chain axis: the
    port's cut Q apply equals the JAX full-grid and cut applies."""
    model, mc, fields = make_masked(spin=spin)
    tm, tc = port_model(model), port_model(mc, cut=True)
    inv = _inv_var(fields)
    s = np.random.default_rng(1).normal(size=(3, model.nfields, model.nstate))
    q_full = np.stack([np.asarray(model.q_apply(jnp.asarray(si),
                                                jnp.asarray(inv)))
                       for si in s])
    q_cut = np.stack([np.asarray(mc.q_apply_cut(jnp.asarray(si),
                                                jnp.asarray(inv)))
                      for si in s])
    scale = float(np.abs(q_full).max())
    for mine in (tc.q_apply_cut(t64(s), t64(inv)), tm.q_apply(t64(s), t64(inv))):
        np.testing.assert_allclose(n(mine), q_cut, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(n(mine), q_full, rtol=0,
                                   atol=1e-12 * scale)
    np.testing.assert_allclose(n(tc.bt_ninv_d()), n(mc.bt_ninv_d()),
                               rtol=0, atol=1e-12 * float(
                                   np.abs(n(mc.bt_ninv_d())).max()))


@pytest.mark.parametrize("spin", [0, 2])
def test_data_loglike_cut_exact(spin):
    """Mirrors test_cut.py::test_data_loglike_cut_exact: one log-likelihood
    per chain, equal to the pixel-domain value of the JAX model."""
    model, mc, _ = make_masked(spin=spin, sigma2=0.5)
    tc = port_model(mc, cut=True)
    x = (np.random.default_rng(2).normal(size=(4, model.nfields,
                                               model.nstate))
         * np.asarray(model.ell_mask()))
    ll_pix = []
    for xi in x:
        resid = model.d - model.forward(jnp.asarray(xi))
        ll_pix.append(-0.5 * float(jnp.sum(model.noise.inv_noise
                                           * resid * resid)))
    ll_cut = n(tc.data_loglike_cut(tc.beam(t64(x))))
    assert ll_cut.shape == (4,)
    np.testing.assert_allclose(ll_cut, ll_pix, rtol=1e-9)
    ll_jax = [float(mc.data_loglike_cut(mc.beam(jnp.asarray(xi))))
              for xi in x]
    np.testing.assert_allclose(ll_cut, ll_jax, rtol=1e-12)


def test_sparse_mask_raises():
    """A band mask with one point hole off the band takes the floor +
    sparse split by default: the floor keeps the band's rows and uniform
    weights, the hole becomes the point set, and the split likelihood
    equals the unsplit one.  (The name is kept from when the port refused
    such masks.)"""
    model, _, _ = make_masked(spin=2)
    arrays = jax_model_arrays(model)
    tau = arrays["tau"].copy()
    tau[:, 2, 3] = 0.0                          # one hole off the band
    arrays["tau"] = tau
    m = model_from_numpy(arrays, device="cpu")
    split = with_cut_decomposition(m)
    plain = with_cut_decomposition(m, sparse_split=False)
    assert split.has_sparse and not plain.has_sparse
    assert split.cut_w_uniform and split.cut_w_equal_fields
    assert split.cut_sht.nrings == plain.cut_sht.nrings - 1
    assert (split.sp_sht.nrows, split.sp_sht.nslots) == (1, 1)
    x = t64(np.random.default_rng(3).normal(size=(2, 2, m.nstate))
            * n(m.ell_mask()))
    u = split.beam(x)
    np.testing.assert_allclose(n(split.data_loglike_cut(u)),
                               n(plain.data_loglike_cut(u)), rtol=1e-12)
