"""The port's floor + sparse-hole mask split against the JAX package
(float64, CPU; the mirror of tests/test_sparse.py): the point-set transform,
the split decomposition and its operators, the CR steps on injected pools,
the table-domain blocked MH against JAX and against the port's direct path,
and three ASIS iterations on the same variates."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_mh_uniforms, make_holey, n,
                          planckish_mask, port_model, t64, valid_normal)
from gibbssampler_tpu.harmonics import variance_expansion_state
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.samplers import aux_gibbs_cr as jax_aux_gibbs
from gibbssampler_tpu.samplers import aux_then_mala_cr as jax_aux_mala
from gibbssampler_tpu.samplers import cls_samplers as jcs
from gibbssampler_tpu.samplers import cr as jcr
from gibbssampler_tpu.samplers import mala_cr as jax_mala
from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu.sht import PointSHT as JaxPointSHT
from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl_grid
from gibbssampler_tpu.sht.points import \
    group_points_by_ring as jax_group_points
from gibbssampler_tpu_torch.harmonics import nstate
from gibbssampler_tpu_torch.interop import state_from_numpy
from gibbssampler_tpu_torch.ops import cut_weights
from gibbssampler_tpu_torch.samplers import aux_gibbs_cr, aux_then_mala_cr
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.samplers import cr as tcr
from gibbssampler_tpu_torch.samplers import mala_cr
from gibbssampler_tpu_torch.schemes import ASISGibbs
from gibbssampler_tpu_torch.sht import gauss_legendre_grid, make_sht
from gibbssampler_tpu_torch.sht.points import PointSHT, group_points_by_ring

LMAX = 16
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
def holey():
    """{spin: (JAX full model, JAX split model, port split model, fields)}
    of one holey-masked dataset per spin, built on first use."""
    cache = {}

    def get(spin):
        if spin not in cache:
            model, mc, fields = make_holey(spin=spin)
            cache[spin] = (model, mc, port_model(model, cut=True), fields)
        return cache[spin]
    return get


# ---------------------------------------------------------------------------
# group_points_by_ring and PointSHT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_width", [64, 3])
def test_group_points_by_ring_matches_jax(max_width):
    """Identical rows, padding and gather indices; with max_width 3 the
    rings holding more points are split into several rows."""
    rng = np.random.default_rng(0)
    ring = rng.integers(0, 6, 40)
    theta = 0.1 + 0.2 * ring
    phi = rng.uniform(0, 2 * np.pi, 40)
    flat = rng.permutation(1000)[:40]
    mine = group_points_by_ring(ring, theta, phi, flat, max_width=max_width)
    ref = jax_group_points(ring, theta, phi, flat, max_width=max_width)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    if max_width == 3:
        assert mine[0].size > np.unique(ring).size and mine[1].shape[1] == 3


def _pt_pair(theta, phi, valid, spin2=True):
    return (JaxPointSHT(theta, phi, valid, LMAX, dtype=jnp.float64,
                        spin0=True, spin2=spin2),
            PointSHT(theta, phi, valid, LMAX, dtype=torch.float64,
                     spin0=True, spin2=spin2, device="cpu"))


def test_point_sht_matches_jax_and_grid():
    """Mirror of test_point_sht_matches_grid: on every pixel of the GL
    grid the point transform equals the grid transform, spin 0 and 2,
    synthesis and adjoint, and JAX's PointSHT (over a chain axis)."""
    grid = gauss_legendre_grid(LMAX)
    phi = np.tile(2 * np.pi * np.arange(grid.nphi) / grid.nphi,
                  (grid.nrings, 1))
    jp, tp = _pt_pair(grid.theta, phi, np.ones_like(phi))
    sht = make_sht(LMAX, dtype=torch.float64, spin2=True, device="cpu")
    rng = np.random.default_rng(0)
    x, e, b = (rng.normal(size=(2, nstate(LMAX))) for _ in range(3))
    f, g = (rng.normal(size=(2, grid.nrings, grid.nphi)) for _ in range(2))
    vm = jax.vmap
    cases = [
        ("spin0 synthesis", tp.synthesis_state(t64(x)),
         vm(jp.synthesis_state)(jnp.asarray(x)),
         sht.synthesis_state(t64(x))),
        ("spin0 adjoint", tp.adjoint_synthesis_state(t64(f)),
         vm(jp.adjoint_synthesis_state)(jnp.asarray(f)),
         sht.adjoint_synthesis_state(t64(f))),
    ]
    mine = tp.synthesis_spin2_state(t64(e), t64(b))
    ref = vm(jp.synthesis_spin2_state)(jnp.asarray(e), jnp.asarray(b))
    grd = sht.synthesis_spin2_state(t64(e), t64(b))
    cases += [(f"spin2 synthesis {k}", mine[i], ref[i], grd[i])
              for i, k in enumerate("QU")]
    mine = tp.adjoint_synthesis_spin2_state(t64(f), t64(g))
    ref = vm(jp.adjoint_synthesis_spin2_state)(jnp.asarray(f), jnp.asarray(g))
    grd = sht.adjoint_synthesis_spin2_state(t64(f), t64(g))
    cases += [(f"spin2 adjoint {k}", mine[i], ref[i], grd[i])
              for i, k in enumerate("EB")]
    for what, a, r, gr in cases:
        _check(a, r, what)
        _check(a, n(gr), what + " vs grid")


def test_point_sht_padded_subset_transpose():
    """Mirror of test_point_sht_padded_subset_transpose: a random padded
    point subset; the values equal the gathered grid synthesis and JAX's,
    padding stays 0, and <A x, f> = <x, A^T f>."""
    grid = gauss_legendre_grid(LMAX)
    sht = make_sht(LMAX, dtype=torch.float64, spin2=True, device="cpu")
    rng = np.random.default_rng(7)
    theta, phi, valid, rows, cols = _padded_points(rng, grid)
    jp, tp = _pt_pair(theta, phi, valid)
    e, b = (t64(rng.normal(size=(2, nstate(LMAX)))) for _ in range(2))
    qg, ug = sht.synthesis_spin2_state(e, b)
    qp, up = tp.synthesis_spin2_state(e, b)
    for i, r in enumerate(rows):
        ok = valid[i] > 0
        _check(qp[:, i, ok], n(qg[:, r, cols[i][ok]]), "Q at the points")
        _check(up[:, i, ok], n(ug[:, r, cols[i][ok]]), "U at the points")
    assert not n(qp)[:, valid == 0].any()
    ref = jax.vmap(jp.synthesis_spin2_state)(jnp.asarray(n(e)),
                                             jnp.asarray(n(b)))
    _check(qp, ref[0], "Q vs JAX")
    gq, gu = (t64(rng.normal(size=qp.shape)) for _ in range(2))
    ea, ba = tp.adjoint_synthesis_spin2_state(gq, gu)
    lhs = float((qp * gq).sum() + (up * gu).sum())
    rhs = float((e * ea).sum() + (b * ba).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))
    x = t64(rng.normal(size=(2, nstate(LMAX))))
    v = tp.synthesis_state(x)
    lhs = float((v * gq).sum())
    rhs = float((x * tp.adjoint_synthesis_state(gq)).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def _padded_points(rng, grid, nrows=5, pmax=6):
    """A random padded point subset of ``grid``: (theta, phi, valid, ring
    of each row, grid column of each slot)."""
    rows = np.sort(rng.choice(grid.nrings, nrows, replace=False))
    phis, vals, cols = [], [], []
    for _ in rows:
        k = int(rng.integers(1, pmax + 1))
        cs = rng.choice(grid.nphi, k, replace=False)
        phis.append(np.pad(2 * np.pi * cs / grid.nphi, (0, pmax - k)))
        vals.append(np.pad(np.ones(k), (0, pmax - k)))
        cols.append(np.pad(cs, (0, pmax - k)))
    return grid.theta[rows], np.stack(phis), np.stack(vals), rows, cols


@pytest.mark.parametrize("wide", [False, True])
def test_values_flat_gsel_match_jax(wide):
    """values_flat_spin0_gsel and values_flat_spin2_gsel (E and B signs)
    against JAX's on a padded point set, per ell and folded into wide
    bins."""
    rng = np.random.default_rng(4)
    theta, phi, valid, _, _ = _padded_points(rng, gauss_legendre_grid(LMAX))
    jp, tp = _pt_pair(theta, phi, valid)
    j_idx = np.array([5, 6, 7, 9, 10])
    seg = (np.array([[1, 0], [1, 0], [1, 0], [0, 1], [0, 1]], np.float64)
           if wide else None)
    gsel = rng.normal(size=(NCH, 2, LMAX + 1, j_idx.size))
    ref = jax.vmap(lambda g: jp.values_flat_spin0_gsel(g, j_idx, seg))(
        jnp.asarray(gsel))
    _check(tp.values_flat_spin0_gsel(t64(gsel), j_idx, seg), ref, "spin0")
    for sp, sm in ((-1.0, -1.0), (1.0, -1.0)):
        ref = jax.vmap(lambda g: jp.values_flat_spin2_gsel(
            g, sp, sm, j_idx, seg))(jnp.asarray(gsel))
        mine = tp.values_flat_spin2_gsel(t64(gsel), sp, sm, j_idx, seg)
        for a, r, k in zip(mine, ref, "QU"):
            _check(a, r, f"spin2 {k} signs {sp}, {sm}")


# ---------------------------------------------------------------------------
# The split decomposition and its operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spin", [0, 2])
def test_split_decomposition_matches_jax(holey, spin):
    """The same floor rows, w_cut, w_sp, d_sp, point rows, point tables and
    cut_c0 / cut_c1 as JAX's split, which is smaller than the unsplit
    cut."""
    model, mc, tc, _ = holey(spin)
    assert tc.has_sparse and tc.cut_w_uniform and tc.cut_w_equal_fields
    np.testing.assert_array_equal(tc.cut_sht.grid.theta, mc.cut_sht.grid.theta)
    assert tc.cut_sht.nrings < port_model(model, cut=True,
                                          sparse_split=False).cut_sht.nrings
    sp, jsp = tc.sp_sht, mc.sp_sht
    assert (sp.nrows, sp.p, sp.nslots) == (jsp.nrows, jsp.p, jsp.nslots)
    for name in ("valid", "cosT", "sinT", "cosF", "sinF", "slot_row",
                 "slot_col"):
        np.testing.assert_array_equal(n(getattr(sp, name)),
                                      np.asarray(getattr(jsp, name)),
                                      err_msg=name)
    tables = ("lam0",) if spin == 0 else ("lam_p2", "lam_m2")
    for name in tables:
        _check(getattr(sp, name), getattr(jsp, name)[0], name, rtol=1e-13)
    for name in ("w_cut", "w_sp", "d_sp", "d_cut", "cut_c0", "cut_c1"):
        _check(getattr(tc, name), getattr(mc, name), name, rtol=1e-12)


@pytest.mark.parametrize("spin", [0, 2])
def test_split_operators_exact(holey, spin):
    """Mirror of test_sparse_split_operators_exact over a chain axis:
    q_apply_cut and data_loglike_cut equal JAX's split operators and the
    full-grid q_apply and pixel likelihood."""
    model, mc, tc, fields = holey(spin)
    var = np.stack([np.asarray(variance_expansion_state(jnp.asarray(f),
                                                        LMAX))
                    for f in fields])
    inv = np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)
    rng = np.random.default_rng(1)
    s = rng.normal(size=(NCH, model.nfields, model.nstate))
    q_full = np.stack([np.asarray(model.q_apply(jnp.asarray(si),
                                                jnp.asarray(inv)))
                       for si in s])
    q_jax = np.stack([np.asarray(mc.q_apply_cut(jnp.asarray(si),
                                                jnp.asarray(inv)))
                      for si in s])
    q_mine = tc.q_apply_cut(t64(s), t64(inv))
    scale = float(np.abs(q_full).max())
    np.testing.assert_allclose(n(q_mine), q_jax, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(n(q_mine), q_full, rtol=0, atol=1e-12 * scale)
    x = s * np.asarray(model.ell_mask())
    ll_pix = []
    for xi in x:
        resid = model.d - model.forward(jnp.asarray(xi))
        ll_pix.append(-0.5 * float(jnp.sum(model.noise.inv_noise
                                           * resid * resid)))
    ll_jax = [float(mc.data_loglike_cut(mc.beam(jnp.asarray(xi))))
              for xi in x]
    u = tc.beam(t64(x))
    ll = n(tc.data_loglike_cut(u))
    np.testing.assert_allclose(ll, ll_pix, rtol=1e-9)
    np.testing.assert_allclose(ll, ll_jax, rtol=1e-12)
    au_cut, au_sp = tc.synthesis_cut_sp(u)
    np.testing.assert_allclose(n(tc.data_loglike_cut(u, au_cut, au_sp)), ll,
                               rtol=1e-13)
    # the fused pairs against the separate transforms
    _check(au_sp, n(tc.synthesis_sp(u)), "synthesis_cut_sp points")
    f_cut = t64(rng.normal(size=au_cut.shape))
    f_sp = t64(rng.normal(size=au_sp.shape)) * tc.sp_sht.valid
    _check(tc.adjoint_cut_sp(f_cut, f_sp),
           n(tc.adjoint_synthesis_cut(f_cut) + tc.adjoint_synthesis_sp(f_sp)),
           "adjoint_cut_sp")


def test_holes_only_mask_keeps_a_zero_floor_row():
    """A mask made only of holes: one zero-weight floor row, as in JAX,
    and the split Q apply still equals the full-grid one."""
    grid = jax_gl_grid(LMAX)
    mask = np.ones((grid.nrings, grid.nphi))
    mask[3, 4:7] = 0.0
    mask[11, 20] = 0.0
    model, mc, fields = make_holey(spin=2, mask=mask)
    tc = port_model(model, cut=True)
    assert tc.has_sparse and tc.cut_sht.nrings == mc.cut_sht.nrings == 1
    np.testing.assert_array_equal(tc.cut_sht.grid.theta, mc.cut_sht.grid.theta)
    assert not n(tc.w_cut).any()
    _check(tc.w_sp, mc.w_sp, "w_sp")
    var = np.stack([np.asarray(variance_expansion_state(jnp.asarray(f),
                                                        LMAX))
                    for f in fields])
    inv = np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)
    s = np.random.default_rng(2).normal(size=(2, model.nfields,
                                              model.nstate))
    q_full = np.stack([np.asarray(model.q_apply(jnp.asarray(si),
                                                jnp.asarray(inv)))
                       for si in s])
    np.testing.assert_allclose(n(tc.q_apply_cut(t64(s), t64(inv))), q_full,
                               rtol=0, atol=1e-12 * np.abs(q_full).max())


def test_planckish_split_counts_at_lmax_512():
    """bench.py's planckish GL mask at lmax 512 splits into 83 floor rings
    and 1547 hole pixels on 201 rings, grouped into 211 point rows of
    width 64 (host-side part of with_cut_decomposition only)."""
    grid = gauss_legendre_grid(512)
    mask = planckish_mask(grid)
    q = (grid.pixel_area / (4.0 * np.pi / grid.npix))[:, None]
    rows, w_cut, w_sp = cut_weights(np.stack([mask, mask]) / 0.04, q)
    sp_pix = np.any(w_sp > 0.0, axis=0)
    rr, cc = np.nonzero(sp_pix)
    theta_rows, phi_pad, _, _ = group_points_by_ring(
        rr, grid.theta[rr], 2 * np.pi * cc / grid.nphi, rr * grid.nphi + cc)
    assert (rows.size, int(sp_pix.sum()), np.unique(rr).size) == (83, 1547,
                                                                 201)
    assert phi_pad.shape == (211, 64)
    assert np.allclose(w_cut, w_cut[:, :, :1], rtol=0, atol=0)
    assert abs(mask.mean() - 0.853) < 1e-3


# ---------------------------------------------------------------------------
# CR steps on injected pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,n_gibbs", [
    ("exact", 1), ("aux_mala", 1), ("aux_mala", 2), ("aux_gibbs", 2),
    ("overrelax", 1), ("overrelax", 3), ("mala", 1), ("ula", 1)])
def test_noise_pool_spec_matches_jax(method, n_gibbs):
    assert tcr.noise_pool_spec(method, {"n_gibbs": n_gibbs}) == \
        jcr.noise_pool_spec(method, {"n_gibbs": n_gibbs})


def _cr_inputs(mc, fields, seed):
    rng = np.random.default_rng(seed)
    var = np.stack([np.asarray(variance_expansion_state(jnp.asarray(f),
                                                        LMAX))
                    for f in fields])
    var = var[None] * np.exp(0.2 * rng.normal(size=(NCH, 1, 1)))
    s_old = np.sqrt(var) * rng.normal(size=var.shape)
    pool = {"state": rng.normal(size=(NCH, 2, mc.nfields, mc.nstate)),
            "aux": rng.normal(size=(NCH, 1) + tuple(mc.w_cut.shape)),
            "sp": rng.normal(size=(NCH, 1) + tuple(mc.w_sp.shape))}
    return var, s_old, pool


@pytest.mark.parametrize("tau", [0.02, 0.5])
def test_cr_steps_match_jax(holey, tau):
    """One aux_gibbs_cr, one mala_cr and one aux_then_mala_cr step per
    chain on the split model, fed the same pools (state, aux, sp) and MALA
    uniforms: states, accepts and CRInfo.extra equal JAX's."""
    _, mc, tc, fields = holey(2)
    var, s_old, pool = _cr_inputs(mc, fields, 3)
    bt = mc.bt_ninv_d()
    _check(tc.bt_ninv_d(), bt, "bt_ninv_d")
    keys = jax.random.split(jax.random.PRNGKey(4), NCH)
    tpool = {k: t64(v) for k, v in pool.items()}
    jpool = [{k: jnp.asarray(v[c]) for k, v in pool.items()}
             for c in range(NCH)]
    args = lambda c: (mc, jnp.asarray(var[c]), bt, jnp.asarray(s_old[c]))
    # aux_gibbs_cr takes the pool only
    ref = [jax_aux_gibbs(keys[c], *args(c), n_gibbs=1, noise=jpool[c])[0]
           for c in range(NCH)]
    mine, _ = aux_gibbs_cr(tc, t64(var), tc.bt_ninv_d(), t64(s_old),
                           noise=tpool)
    _check(mine, np.stack(ref), "aux_gibbs_cr")
    # mala_cr: the pool's first state field, the uniform of split(key)[1]
    u = t64([float(jax.random.uniform(jax.random.split(k)[1],
                                      dtype=jnp.float64)) for k in keys])
    ref = [jax_mala(keys[c], *args(c), tau=tau, noise=jpool[c])
           for c in range(NCH)]
    mine, info = mala_cr(tc, t64(var), tc.bt_ninv_d(), t64(s_old), tau=tau,
                         noise=tpool, u=u)
    _check(mine, np.stack([r[0] for r in ref]), "mala_cr")
    _check(info.extra, [float(r[1].extra) for r in ref], "mala extra")
    np.testing.assert_array_equal(n(info.accept),
                                  [float(r[1].accept) for r in ref])
    # the composed step: aux (first state field), then MALA (the second)
    u = t64([float(jax.random.uniform(jax.random.split(
        jax.random.split(k)[1])[1], dtype=jnp.float64)) for k in keys])
    ref = [jax_aux_mala(keys[c], *args(c), n_gibbs=1, tau=tau,
                        noise=jpool[c]) for c in range(NCH)]
    mine, info = aux_then_mala_cr(tc, t64(var), tc.bt_ninv_d(), t64(s_old),
                                  n_gibbs=1, tau=tau, noise=tpool, u=u)
    _check(mine, np.stack([r[0] for r in ref]), "aux_then_mala_cr")
    _check(info.extra, [float(r[1].extra) for r in ref], "extra")
    np.testing.assert_array_equal(n(info.accept),
                                  [float(r[1].accept) for r in ref])
    if tau == 0.5:
        assert 0.0 in n(info.accept)


# ---------------------------------------------------------------------------
# The table-domain blocked MH on the split model
# ---------------------------------------------------------------------------

# EE: unit bins in one block; BB: unit bins then 2-ell bins, a big block
# followed by single-bin blocks
BB_BINS = {"unit": np.arange(2, LMAX + 2),
           "wide": np.array([2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17])}


def _mh_setup(fields, bb, big=4):
    bins = [np.arange(2, LMAX + 2), BB_BINS[bb]]
    nbs = [len(b) - 1 for b in bins]
    blocks = [[(0, nbs[0])],
              [(0, big)] + [(i, i + 1) for i in range(big, nbs[1])]]
    dl0 = [np.maximum([f[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])],
                      1e-3) for f, b in zip(fields, bins)]
    return bins, blocks, [0.5 * d for d in dl0], dl0


def _mh_inputs(mc, bins, blocks, dl0, n_iter, seed):
    rng = np.random.default_rng(seed)
    dls = [d * np.exp(0.2 * rng.normal(size=(NCH, len(d)))) for d in dl0]
    s_nc = valid_normal(rng, (NCH, mc.nfields, mc.nstate), LMAX)
    keys = jax.random.split(jax.random.PRNGKey(seed), NCH)
    ntot = sum(len(b) - 1 for b in bins)
    nblocks = sum(map(len, blocks))
    uni = [jax_mh_uniforms(k, n_iter, ntot, nblocks) for k in keys]
    return (keys, dls, s_nc, t64(np.stack([u[0] for u in uni])),
            t64(np.stack([u[1] for u in uni])))


@pytest.mark.parametrize("bb", sorted(BB_BINS))
def test_sparse_table_engine_matches_jax_and_direct(holey, monkeypatch, bb):
    """nc_cls_sample_cut on the split model over 2 sweeps, chunks of at
    most 3 bins / 3 ells in both packages: equal to JAX's table engine on
    the same keys, and to the port's direct nc_cls_sample on the same
    uniforms (D_ell, accepts, final log-likelihood)."""
    _, mc, tc, fields = holey(2)
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    bins, blocks, sig, dl0 = _mh_setup(fields, bb)
    keys, dls, s_nc, up, ua = _mh_inputs(mc, bins, blocks, dl0, 2, 5)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
        k, d, s, mc, bins, blocks, sig, n_iter=2)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    plan = tcs.CutMHPlan(tc, bins, blocks, sig, dtype=torch.float64)
    assert len(plan.chunks) >= 2 and all(c.sp_tab is not None
                                         for c in plan.chunks)
    if bb == "wide":
        assert any(c.segj is not None for c in plan.chunks)
    dlt = tuple(t64(d) for d in dls)
    fast = tcs.nc_cls_sample_cut(dlt, t64(s_nc), tc, bins, blocks, sig,
                                 n_iter=2, u_prop=up, u_acc=ua, plan=plan)
    direct = tcs.nc_cls_sample(dlt, t64(s_nc), tcs.make_nc_log_likelihood(
        tc, bins), bins, blocks, sig, n_iter=2, u_prop=up, u_acc=ua)
    for f in range(2):
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


@pytest.mark.parametrize("engine", ["auto", False])
def test_sparse_engines_match_direct(holey, engine):
    """Mirror of test_sparse_engines_match_direct: the table engine
    ("auto") and the phi-domain engine (False) on the split model each
    equal JAX's direct likelihood path over 3 sweeps of the same keys."""
    _, mc, tc, fields = holey(2)
    bins = [np.arange(2, LMAX + 2)] * 2
    nb = LMAX - 1
    blocks = [[(0, nb)], [(0, nb - 6)] + [(i, i + 1)
                                          for i in range(nb - 6, nb)]]
    sig = [np.full(nb, 2.0), np.full(nb, 2.0)]
    assert tcs.CutMHPlan(tc, bins, blocks, sig, mdomain=engine).engine == (
        "phi" if engine is False else "table")
    keys, dls, s_nc, up, ua = _mh_inputs(
        mc, bins, blocks, [np.maximum(f[2:], 1e-3) for f in fields], 3, 7)
    ll_j = jcs.make_nc_log_likelihood(mc, bins, all_sph=False)
    ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample(
        k, d, s, ll_j, bins, blocks, sig, n_iter=3)))(
            keys, tuple(jnp.asarray(d) for d in dls), jnp.asarray(s_nc))
    dl, info = tcs.nc_cls_sample_cut(tuple(t64(d) for d in dls), t64(s_nc),
                                     tc, bins, blocks, sig, n_iter=3,
                                     mdomain=engine, u_prop=up, u_acc=ua)
    for f in range(2):
        _check(dl[f], ref[0][f], f"dl[{f}]")
        np.testing.assert_array_equal(n(info.accept[f]),
                                      np.asarray(ref[1].accept[f]))


# ---------------------------------------------------------------------------
# The scheme
# ---------------------------------------------------------------------------

def test_asis_step_matches_jax_on_split_model(holey, monkeypatch):
    """Three ASISGibbs iterations of NCH chains on the split model: the JAX
    scheme's vmapped step and the port's batched step, fed the same pools
    (with the "sp" block), MALA uniforms, gamma variates and MH uniforms,
    agree at every iteration; the CR and MH accepts are equal."""
    _, mc, tc, fields = holey(2)
    monkeypatch.setattr(jcs, "_MDOMAIN_CHUNK", 3)
    monkeypatch.setattr(tcs, "_MDOMAIN_CHUNK", 3)
    bins, blocks, _, dl0 = _mh_setup(fields, "wide")
    sig = [0.3 * d for d in dl0]
    kw = dict(n_iter_mh=1, cr_method="aux_mala", cr_options=OPTS)
    jsch = JaxASIS(mc, bins, blocks, sig, **kw)
    tsch = ASISGibbs(tc, bins, blocks, sig, **kw)
    assert jsch._use_cut_mh and tsch._use_cut_mh
    pool_t = tsch.draw_noise_pool(NCH, torch.Generator().manual_seed(0))
    assert set(pool_t) == {"state", "aux", "sp"}
    assert tuple(pool_t["sp"].shape) == (NCH, 1) + tuple(mc.w_sp.shape)
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
        keys = jax.random.split(jax.random.PRNGKey(100 + it), NCH)
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
