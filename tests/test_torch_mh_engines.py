"""The port's phi-domain and coefficient m-domain blocked-MH engines, and the
ell-selected transforms under them, against the JAX package (float64, CPU).

- ``_lsel_F``, ``_lsynth_stack_binned``, ``ring_cs_lsel_*`` and
  ``synthesis_*_state_lsel`` on SHT (GL rows, phased rows, the Nyquist
  column at nphi = 2 lmax) and on PointSHT, and ``values_lsel_*``;
- mirrors of tests/test_cut.py's ring half-spectrum identities;
- ``nc_cls_sample_cut`` on each engine against JAX's on the same keys and
  the port's direct ``nc_cls_sample`` on the same uniforms (the band model,
  the holey model with and without the floor + sparse-hole split, the
  HEALPix cap-hole model, spin 3, the HEALPix band's phased Nyquist rows);
- the table engine on spin-3 (T, E, B) models, which crashed before;
- ASIS and PNCP steps with ``mh_fast="phi"`` against JAX's scheme step.

The uniforms come from the ``jax.random.split``s the JAX samplers make
(``torch_parity.jax_mh_uniforms``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import (jax_mh_uniforms, make_holey, make_holey_healpix,
                          make_masked, make_masked_healpix, n, port_model,
                          t64, valid_normal)
from gibbssampler_tpu.samplers import cls_samplers as jcs
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.sht import SHT, PointSHT

LMAX = 10
NCH = 2
RTOL = 1e-9


def _check(mine, ref, what, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(mine), ref, rtol=rtol,
                               atol=rtol * max(1e-300, float(np.abs(ref).max())),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the ell-selected transforms
# ---------------------------------------------------------------------------

ELLBINS = [(2, 3), (3, 4), (5, 9), (9, 10)]       # unit and wide bins


def _bins_sel(ellbins, L):
    """(j_idx, seg, sel) of a list of ell ranges."""
    j_idx = np.concatenate([np.arange(lo, hi) for lo, hi in ellbins])
    seg = np.zeros((len(j_idx), len(ellbins)))
    sel = np.zeros((len(ellbins), L))
    k = 0
    for i, (lo, hi) in enumerate(ellbins):
        seg[k: k + hi - lo, i] = 1.0
        sel[i, lo:hi] = 1.0
        k += hi - lo
    return j_idx, seg, sel


def _grid_pair(kind, lmax=LMAX):
    """The same rows as a JAX and a port SHT: GL rings ("gl"), those rings
    with phi0 = 0.1 on every other row ("phased"), or phased rows at nphi
    = 2 lmax ("nyquist")."""
    from gibbssampler_tpu.sht import SHT as JaxSHT
    from gibbssampler_tpu.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(lmax)
    phi0 = np.where(np.arange(grid.nrings) % 2, 0.1, 0.0)
    if kind == "phased":
        grid = dataclasses.replace(grid, phi0=phi0)
    elif kind == "nyquist":
        grid = dataclasses.replace(grid, nphi=2 * lmax, phi0=phi0)
    alias = kind == "nyquist"
    return (JaxSHT(grid, lmax, dtype=jnp.float64, spin2=True,
                   allow_aliasing=alias),
            SHT(grid, lmax, dtype=torch.float64, spin2=True, device="cpu",
                allow_aliasing=alias))


@pytest.mark.parametrize("kind", ["gl", "phased", "nyquist"])
def test_lsel_transforms_match_jax(kind):
    """_lsel_F (unit and wide bins), _lsynth_stack_binned, ring_cs_lsel_*
    (state and prebuilt-grid forms, E and B alone) and
    synthesis_*_state_lsel on the same rows and a batch of 2 states."""
    js, ts = _grid_pair(kind)
    L = LMAX + 1
    rng = np.random.default_rng(0)
    e, b = (rng.normal(size=(2, 2 * L * L)) for _ in range(2))
    j_idx, seg, sel = _bins_sel(ELLBINS, L)
    jv = lambda f, *a: jax.vmap(f)(*(jnp.asarray(x) for x in a))
    g = ts._state_grids(t64(e))
    for sg in (None, seg):
        jj = j_idx if sg is not None else np.array([2, 4, 7, LMAX])
        ref = jax.vmap(lambda x: js._lsel_F(js.lam0, js._state_grids(x), jj,
                                            sg))(jnp.asarray(e))
        _check(ts._lsel_F(ts.lam0, g, jj, sg), ref, f"_lsel_F {sg is None}")
    ref = jax.vmap(lambda x: js._lsynth_stack_binned(
        js.lam_p2, js._state_grids(x), jnp.asarray(sel)))(jnp.asarray(e))
    _check(ts._lsynth_stack_binned(ts.lam_p2, g, sel), ref, "binned")
    for a, r in zip(ts.ring_cs_lsel_spin0(t64(e), j_idx, seg),
                    jv(lambda x: js.ring_cs_lsel_spin0(x, j_idx, seg), e)):
        _check(a, r, "ring_cs_lsel_spin0")
    mine = ts.ring_cs_lsel_spin2(t64(e), t64(b), j_idx, seg)
    ref = jv(lambda x, y: js.ring_cs_lsel_spin2(x, y, j_idx, seg), e, b)
    for a, r in zip(sum(mine, ()), sum(ref, ())):
        _check(a, r, "ring_cs_lsel_spin2")
    for which, x in (("e", e), ("b", b)):
        gt, sp, sm = ts.lsel_grid_spin2_single(t64(x), which)
        mine = ts.ring_cs_lsel_spin2_grids(gt, sp, sm, j_idx, seg)
        ref = jax.vmap(lambda y: js.ring_cs_lsel_spin2_grids(
            *js.lsel_grid_spin2_single(y, which), j_idx, seg))(jnp.asarray(x))
        for a, r in zip(sum(mine, ()), sum(ref, ())):
            _check(a, r, f"ring_cs_lsel_spin2_grids {which}")
    _check(ts.synthesis_state_lsel(t64(e), sel),
           jv(lambda x: js.synthesis_state_lsel(x, jnp.asarray(sel)), e),
           "synthesis_state_lsel")
    for a, r in zip(ts.synthesis_spin2_state_lsel(t64(e), t64(b), sel),
                    jv(lambda x, y: js.synthesis_spin2_state_lsel(
                        x, y, jnp.asarray(sel)), e, b)):
        _check(a, r, "synthesis_spin2_state_lsel")


def test_point_lsel_values_match_jax():
    """PointSHT's values_lsel_spin*_grids and synthesis_*_state_lsel on a
    ragged point set, against JAX's."""
    from gibbssampler_tpu.sht import SHT as JaxSHT
    from gibbssampler_tpu.sht import PointSHT as JaxPointSHT
    L = LMAX + 1
    rng = np.random.default_rng(1)
    theta = np.array([0.3, 1.1, 1.6, 2.5])
    phi = rng.uniform(0, 2 * np.pi, size=(4, 5))
    valid = np.ones((4, 5))
    valid[1, 3:] = 0.0
    valid[3, 1:] = 0.0
    jp = JaxPointSHT(theta, phi, valid, LMAX, dtype=jnp.float64, spin2=True)
    tp = PointSHT(theta, phi, valid, LMAX, dtype=torch.float64, spin2=True,
                  device="cpu")
    e, b = (rng.normal(size=(2, 2 * L * L)) for _ in range(2))
    j_idx, seg, sel = _bins_sel(ELLBINS, L)
    jv = lambda f, *a: jax.vmap(f)(*(jnp.asarray(x) for x in a))
    _check(tp.values_lsel_spin0_grids(tp._state_grids(t64(e)), j_idx, seg),
           jv(lambda x: jp.values_lsel_spin0_grids(jp._state_grids(x),
                                                   j_idx, seg), e),
           "values_lsel_spin0_grids")
    for which, x in (("e", e), ("b", b)):
        # the point set's single-field grid, as the SHT method builds it
        grid = SHT.lsel_grid_spin2_single(tp, t64(x), which)
        mine = tp.values_lsel_spin2_grids(*grid, j_idx, seg)
        ref = jax.vmap(lambda y: jp.values_lsel_spin2_grids(
            *JaxSHT.lsel_grid_spin2_single(jp, y, which), j_idx, seg))(
                jnp.asarray(x))
        for a, r in zip(mine, ref):
            _check(a, r, f"values_lsel_spin2_grids {which}")
    _check(tp.synthesis_state_lsel(t64(e), sel),
           jv(lambda x: jp.synthesis_state_lsel(x, jnp.asarray(sel)), e),
           "synthesis_state_lsel")
    for a, r in zip(tp.synthesis_spin2_state_lsel(t64(e), t64(b), sel),
                    jv(lambda x, y: jp.synthesis_spin2_state_lsel(
                        x, y, jnp.asarray(sel)), e, b)):
        _check(a, r, "points synthesis_spin2_state_lsel")


def test_ring_halfspec_identities():
    """Mirror of tests/test_cut.py::test_ring_halfspec_identities:
    ring_cs_lsel_spin2, ring_cs_of_maps and ring_dot_weights reproduce the
    per-bin maps and their w-weighted dot products exactly."""
    _, mc, _ = make_masked(spin=2, sigma2=0.5, lmax=LMAX)
    tc = port_model(mc, cut=True)
    cut = tc.cut_sht
    rng = np.random.default_rng(0)
    e, b = (t64(rng.standard_normal(tc.nstate)) for _ in range(2))
    j_idx, seg, sel = _bins_sel(ELLBINS, LMAX + 1)
    q_ref, u_ref = (n(x) for x in cut.synthesis_spin2_state_lsel(e, b, sel))
    (Qc, Qs), (Uc, Us) = (tuple(n(x) for x in p)
                          for p in cut.ring_cs_lsel_spin2(e, b, j_idx, seg))
    th = 2 * np.pi * np.arange(cut.nphi) / cut.nphi
    cosm = np.cos(np.outer(np.arange(LMAX + 1), th))
    sinm = np.sin(np.outer(np.arange(LMAX + 1), th))
    q_m = Qc @ cosm + Qs @ sinm
    u_m = Uc @ cosm + Us @ sinm
    scale = np.abs(q_ref).max()
    np.testing.assert_allclose(q_m, q_ref, atol=1e-12 * scale)
    np.testing.assert_allclose(u_m, u_ref, atol=1e-12 * scale)
    pwc, pws = (n(x) for x in cut.ring_dot_weights())
    w_ring = n(tc.w_cut)[0, :, 0]
    q_i_m = (np.einsum("r,brm,m->b", w_ring, Qc ** 2, pwc)
             + np.einsum("r,brm,m->b", w_ring, Qs ** 2, pws))
    q_i_p = np.einsum("r,brj->b", w_ring, q_ref ** 2)
    np.testing.assert_allclose(q_i_m, q_i_p, rtol=1e-11)
    r = rng.standard_normal(q_ref.shape[1:])
    Rc, Rs = (n(x) for x in cut.ring_cs_of_maps(t64(r)))
    rho_m = np.einsum("brm,rm->b", Qc, Rc) + np.einsum("brm,rm->b", Qs, Rs)
    np.testing.assert_allclose(rho_m, np.einsum("rj,brj->b", r, q_ref),
                               rtol=1e-10)


def test_ring_dot_weights_nyquist():
    """Mirror of tests/test_cut.py::test_ring_dot_weights_nyquist: at
    nphi = 2 lmax the m = lmax column carries pw_cos = nphi, pw_sin = 0,
    and the Parseval dot product of the per-bin coefficients equals the
    pixel one."""
    from gibbssampler_tpu_torch.sht import SphereGrid
    lmax = 8
    nphi = 2 * lmax
    g = SphereGrid(name="nyq", theta=np.array([1.2, 1.5, 1.9]),
                   weights=np.ones(3), nphi=nphi,
                   phi0=np.array([0.0, 0.1, 0.0]))
    sht = SHT(g, lmax, dtype=torch.float64, spin2=True, device="cpu",
              allow_aliasing=True)
    rng = np.random.default_rng(1)
    L = lmax + 1
    e, b = (t64(rng.standard_normal(2 * L * L)) for _ in range(2))
    j_idx = np.arange(2, lmax + 1)
    (Qc, Qs), _ = sht.ring_cs_lsel_spin2(e, b, j_idx, None)
    sel = np.zeros((len(j_idx), L))
    sel[np.arange(len(j_idx)), j_idx] = 1.0
    q_ref, _ = sht.synthesis_spin2_state_lsel(e, b, sel)
    pwc, pws = (n(x) for x in sht.ring_dot_weights())
    assert pwc[lmax] == nphi and pws[lmax] == 0.0
    Qc, Qs, q_ref = n(Qc), n(Qs), n(q_ref)
    dot_m = (np.einsum("brm,crm,m->bc", Qc, Qc, pwc)
             + np.einsum("brm,crm,m->bc", Qs, Qs, pws))
    dot_p = np.einsum("brj,crj->bc", q_ref, q_ref)
    np.testing.assert_allclose(dot_m, dot_p, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# the engines against JAX and the direct path
# ---------------------------------------------------------------------------

def _run_engines(jm, tm, bins, blocks, sig, dl0, kw_list, seed, n_iter=3,
                 jax_ref=True):
    """Each engine of ``kw_list`` ((keyword arguments, expected engine)
    pairs) on the same keys: the port against JAX's nc_cls_sample_cut (when
    ``jax_ref``) and against the port's direct nc_cls_sample on the same
    uniforms.  Returns the port's results per engine."""
    lmax = tm.lmax
    rng = np.random.default_rng(seed)
    dls = [d * np.exp(0.2 * rng.normal(size=(NCH, len(d)))) for d in dl0]
    s_nc = valid_normal(rng, (NCH, tm.nfields, tm.nstate), lmax)
    keys = jax.random.split(jax.random.PRNGKey(seed), NCH)
    ntot = sum(len(b) - 1 for b in bins)
    nblocks = sum(map(len, blocks))
    uni = [jax_mh_uniforms(k, n_iter, ntot, nblocks) for k in keys]
    up = t64(np.stack([u[0] for u in uni]))
    ua = t64(np.stack([u[1] for u in uni]))
    dlt = tuple(t64(d) for d in dls)
    direct = tcs.nc_cls_sample(dlt, t64(s_nc), tcs.make_nc_log_likelihood(
        tm, bins), bins, blocks, sig, n_iter=n_iter, u_prop=up, u_acc=ua)
    out = {}
    for kw, engine in kw_list:
        plan = tcs.CutMHPlan(tm, bins, blocks, sig, dtype=torch.float64,
                             **kw)
        dl, info = tcs.nc_cls_sample_cut(dlt, t64(s_nc), tm, bins, blocks,
                                         sig, n_iter=n_iter, u_prop=up,
                                         u_acc=ua, plan=plan)
        assert plan.engine == engine, (kw, plan.engine)
        refs = [("direct", tuple(n(d) for d in direct[0]),
                 tuple(n(a) for a in direct[1].accept),
                 n(direct[1].log_like))]
        if jax_ref:
            ref = jax.jit(jax.vmap(lambda k, d, s: jcs.nc_cls_sample_cut(
                k, d, s, jm, bins, blocks, sig, n_iter=n_iter, **kw)))(
                    keys, tuple(jnp.asarray(d) for d in dls),
                    jnp.asarray(s_nc))
            refs.append(("JAX", ref[0], ref[1].accept, ref[1].log_like))
        for what, rdl, racc, rll in refs:
            for f in range(len(bins)):
                _check(dl[f], rdl[f], f"{engine} dl[{f}] vs {what}")
                np.testing.assert_array_equal(
                    n(info.accept[f]), np.asarray(racc[f]),
                    err_msg=f"{engine} accepts[{f}] vs {what}")
            _check(info.log_like, rll, f"{engine} log_like vs {what}")
        out[engine] = (dl, info)
    acc = np.concatenate([n(a).ravel() for a in info.accept])
    assert 0.0 < acc.mean() < 1.0
    return out


def _unit_setup(fields, lmax, big_fields, nsingle, scale=0.5):
    """Unit bins per field; the first ``big_fields`` fields one block each,
    the rest a big block then ``nsingle`` single-bin blocks."""
    nb = lmax - 1
    bins = [np.arange(2, lmax + 2)] * len(fields)
    blocks = [[(0, nb)] if f < big_fields else
              [(0, nb - nsingle)] + [(i, i + 1)
                                     for i in range(nb - nsingle, nb)]
              for f in range(len(fields))]
    dl0 = [np.maximum(f[2:], 1e-3) for f in fields]
    sig = [scale * d for d in dl0]
    return bins, blocks, sig, dl0


@pytest.fixture(scope="module")
def band():
    _, mc, fields = make_masked(spin=2, sigma2=0.5, lmax=LMAX)
    return mc, port_model(mc, cut=True), fields


def test_band_engines_match_jax(band, monkeypatch):
    """The band model: the phi engine (mdomain False) and the coefficient
    engine ("m") against JAX's and the direct path, chunks of at most 3
    bins in both packages; the table engine ("auto") equals the
    coefficient engine (mirror of test_tdomain_engine_matches_coefficient_
    engine)."""
    mc, tc, fields = band
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_MDOMAIN_CHUNK", 3)
        monkeypatch.setattr(mod, "_PHI_CHUNK", 3)
    bins, blocks, sig, dl0 = _unit_setup(fields, LMAX, 1, 5)
    out = _run_engines(mc, tc, bins, blocks, sig, dl0,
                       [(dict(mdomain=False), "phi"),
                        (dict(mdomain="m"), "coef")], 21)
    tab = _run_engines(mc, tc, bins, blocks, sig, dl0,
                       [({}, "table")], 21, jax_ref=False)["table"]
    for f in range(2):
        _check(tab[0][f], n(out["coef"][0][f]), "table vs coef")


def _holey_nosplit():
    """tests/test_cut.py::test_phi_engine_holey_mask_matches_direct's
    dataset at lmax 10: an apodized band with point-source holes, cut
    without the split (w_cut not azimuthally uniform)."""
    from gibbssampler_tpu.inference import example_dl, simulate_dataset
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    keep = np.clip((lat - 0.25) / 0.15, 0.0, 1.0)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi)).copy()
    rng = np.random.default_rng(7)
    for _ in range(6):
        r = rng.integers(0, grid.nrings)
        p = rng.integers(0, grid.nphi)
        mask[r, p: p + 2] = 0.0
    fields = np.stack([example_dl(LMAX, "ee", amp=10.0),
                       example_dl(LMAX, "bb", amp=10.0)])
    model, _ = simulate_dataset(jax.random.PRNGKey(4), LMAX, spin=2,
                                dl_fields=fields, noise_sigma2=0.5,
                                fwhm_radians=0.05, mask=mask,
                                dtype=jnp.float64)
    return jax_cut(model, sparse_split=False), fields


def test_phi_engine_holey_mask_matches_direct(monkeypatch):
    """Mirror of tests/test_cut.py::test_phi_engine_holey_mask_matches_
    direct: without the split the cut weights are not azimuthally uniform,
    so "auto" takes the phi engine; it equals JAX's and the direct path,
    and chunks of 3 bins equal one chunk of all (1000)."""
    mc, fields = _holey_nosplit()
    tc = port_model(mc, cut=True, sparse_split=False)
    assert not tc.cut_w_uniform and not tcs._mdomain_eligible(tc)
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_PHI_CHUNK", 3)
    bins, blocks, sig, dl0 = _unit_setup(fields, LMAX, 1, 5)
    small = _run_engines(mc, tc, bins, blocks, sig, dl0,
                         [({}, "phi")], 22)["phi"]
    monkeypatch.setattr(tcs, "_PHI_CHUNK", 1000)
    big = _run_engines(mc, tc, bins, blocks, sig, dl0, [({}, "phi")], 22,
                       jax_ref=False)["phi"]
    for f in range(2):
        _check(small[0][f], n(big[0][f]), "chunk 3 vs chunk 1000")


@pytest.mark.parametrize("mdomain", ["m", False])
def test_sparse_split_takes_phi(monkeypatch, mdomain):
    """Mirror of the phi cases of tests/test_sparse.py::test_sparse_
    engines_match_direct on the holey split model (lmax 16): "m" falls
    back to the phi engine under the split, as False pins it; both equal
    JAX's and the direct path."""
    _, mc, fields = make_holey(spin=2)
    tc = port_model(mc, cut=True, sparse_split=True)
    assert tc.has_sparse
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_PHI_CHUNK", 4)
    bins, blocks, sig, dl0 = _unit_setup(fields, 16, 1, 6, scale=2.0)
    sig = [np.full(15, 2.0)] * 2
    _run_engines(mc, tc, bins, blocks, sig, dl0,
                 [(dict(mdomain=mdomain), "phi")], 23)


def test_healpix_cap_holes_phi_engine_matches_direct(monkeypatch):
    """Mirror of tests/test_sparse.py::test_healpix_cap_holes_engines_
    match_direct (nside 8, padded layout, cap-ring holes in the point
    set): the phi engine against JAX's and the direct path."""
    _, mc, fields = make_holey_healpix(spin=2)
    tc = port_model(mc, cut=True, sparse_split=True)
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_PHI_CHUNK", 3)
    bins, blocks, sig, dl0 = _unit_setup(fields, 16, 1, 5)
    sig = [np.full(15, 2.0)] * 2
    _run_engines(mc, tc, bins, blocks, sig, dl0,
                 [(dict(mdomain=False), "phi")], 24)


@pytest.mark.parametrize("spin", [0, 2])
def test_mdomain_sweep_matches_phi_sweep_healpix(spin):
    """Mirror of tests/test_cut.py::test_mdomain_sweep_matches_phi_sweep_
    healpix: the HEALPix band's belt rows are phased and sit at nphi =
    2 lmax; the table, coefficient and phi engines equal the direct path,
    and the coefficient engine (rotated half spectra, the Nyquist weight)
    equals JAX's."""
    _, mc, fields = make_masked_healpix(spin=spin, sigma2=0.5)
    tc = port_model(mc, cut=True)
    lmax = tc.lmax
    assert tc.cut_sht.has_phase and tc.cut_sht.nphi == 2 * lmax
    bins, blocks, sig, dl0 = _unit_setup(fields, lmax, len(fields) - 1,
                                         (lmax - 1) // 2)
    out = _run_engines(mc, tc, bins, blocks, sig, dl0,
                       [(dict(mdomain="m"), "coef")], 25)
    rest = _run_engines(mc, tc, bins, blocks, sig, dl0,
                        [({}, "table"), (dict(mdomain=False), "phi")], 25,
                        jax_ref=False)
    for f in range(len(fields)):
        for e in ("table", "phi"):
            _check(rest[e][0][f], n(out["coef"][0][f]), f"{e} vs coef")


def _spin3(kind, lmax=LMAX, noise=0.5):
    """A JAX spin-3 (T, E, B) dataset on the GL grid: a band cut or the
    holey mask's floor + sparse-hole split; ``noise`` one variance or one
    per map (T, Q, U)."""
    from gibbssampler_tpu.inference import example_dl, simulate_dataset
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu.sht import gauss_legendre_grid
    from torch_parity import holey_mask
    grid = gauss_legendre_grid(lmax)
    if kind == "band":
        keep = (np.abs(np.pi / 2 - grid.theta) > 0.3).astype(np.float64)
        mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    else:
        mask = holey_mask(grid)
    fields = np.stack([example_dl(lmax, k, amp=10.0)
                       for k in ("tt", "ee", "bb")])
    model, _ = simulate_dataset(jax.random.PRNGKey(0), lmax, spin=3,
                                dl_fields=fields, noise_sigma2=noise,
                                fwhm_radians=0.05, mask=mask,
                                dtype=jnp.float64)
    split = kind == "holey"
    mc = jax_cut(model, sparse_split=split)
    return mc, port_model(mc, cut=True, sparse_split=split), fields


REPAIR_BLOCKS = [[(0, 9)], [(0, 9)], [(0, 5), (5, 6), (6, 7), (7, 8),
                                      (8, 9)]]


@pytest.mark.parametrize("kind", ["band", "holey"])
def test_spin3_table_engine_matches_jax(kind):
    """The table engine on a spin-3 cut model (T, E, B blocks, singles in
    BB), which raised a shape error on its second sweep: over 2 sweeps it
    equals JAX's nc_cls_sample_cut ("auto") and the direct path, on a band
    model and on a holey split model."""
    mc, tc, fields = _spin3(kind)
    bins = [np.arange(2, LMAX + 2)] * 3
    dl0 = [np.maximum(f[2:], 1e-3) for f in fields]
    sig = [0.5 * d for d in dl0]
    _run_engines(mc, tc, bins, REPAIR_BLOCKS, sig, dl0, [({}, "table")],
                 26 if kind == "band" else 27, n_iter=2)


def test_spin3_engines_match_jax(monkeypatch):
    """Mirror of tests/test_cut.py::test_mdomain_sweep_matches_phi_sweep
    (spin 3): on the spin-3 band model the phi and coefficient engines
    equal JAX's and the direct path; the table engine equals them."""
    mc, tc, fields = _spin3("band")
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_MDOMAIN_CHUNK", 3)
        monkeypatch.setattr(mod, "_PHI_CHUNK", 3)
    bins, blocks, sig, dl0 = _unit_setup(fields, LMAX, 2, 4)
    out = _run_engines(mc, tc, bins, blocks, sig, dl0,
                       [(dict(mdomain=False), "phi"),
                        (dict(mdomain="m"), "coef")], 28)
    tab = _run_engines(mc, tc, bins, blocks, sig, dl0, [({}, "table")], 28,
                       jax_ref=False)["table"]
    for f in range(3):
        _check(tab[0][f], n(out["phi"][0][f]), "table vs phi")


def test_mdomain_singles_spanning_fields_spin3():
    """Mirror of tests/test_cut.py::test_mdomain_singles_spanning_fields_
    spin3: every block a single, across T, E and B (no big block), so
    the field-pure chunks hand the residual across fields; on unequal T
    and P noise (the coefficient engine's case) the three engines agree
    with the direct path, and the coefficient engine with JAX's."""
    mc, tc, fields = _spin3("band", noise=np.array([0.5, 0.05, 0.05]))
    assert not tc.cut_w_equal_fields
    bins = [np.arange(2, LMAX + 2)] * 3
    blocks = [[(i, i + 1) for i in range(LMAX - 1)]] * 3
    dl0 = [np.maximum(f[2:], 1e-3) for f in fields]
    sig = [0.5 * d for d in dl0]
    _run_engines(mc, tc, bins, blocks, sig, dl0, [({}, "coef")], 29)
    _run_engines(mc, tc, bins, blocks, sig, dl0,
                 [(dict(mdomain=False), "phi")], 29, jax_ref=False)


# ---------------------------------------------------------------------------
# the schemes with mh_fast="phi"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["asis", "pncp"])
def test_scheme_steps_with_phi_engine_match_jax(monkeypatch, scheme):
    """Three ASISGibbs / PNCPGibbs (l_cut EE 4, BB 6) steps with
    mh_fast="phi" against JAX's vmapped scheme step on the same noise
    pools, MALA and gamma variates and MH uniforms
    (tests/test_torch_pncp.py's ``_run_steps``): the states, D_ell and
    accepts agree; chunks of at most 2 bins in both packages."""
    import test_torch_pncp as tp
    from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
    from gibbssampler_tpu.schemes import PNCPGibbs as JaxPNCP
    from gibbssampler_tpu_torch.schemes import ASISGibbs, PNCPGibbs
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_PHI_CHUNK", 2)
    _, jm, fields = make_masked(spin=2, sigma2=tp.SIGMA2)
    tm = port_model(jm, cut=True)
    bins = [tp.BINS, tp.BINS]
    blocks = [[(0, 2), (2, 5)], [(0, 2)] + [(i, i + 1) for i in range(2, 5)]]
    sig = [0.3 * tp._binned(f) for f in fields]
    kw = dict(cr_method="aux_mala", cr_options=tp.OPTS, mh_fast="phi")
    if scheme == "pncp":
        kw["l_cut"] = (4, 6)
        jsch, tsch = (JaxPNCP(jm, bins, blocks, sig, **kw),
                      PNCPGibbs(tm, bins, blocks, sig, **kw))
    else:
        jsch, tsch = (JaxASIS(jm, bins, blocks, sig, **kw),
                      ASISGibbs(tm, bins, blocks, sig, **kw))
    assert jsch._use_cut_mh and tsch.mh_plan.engine == "phi"
    tp._run_steps(jsch, tsch, jm, fields, 3, "aux_mala", "pncp", 31)
