"""The transform options of the port against the JAX package's (float64,
CPU, one torch thread): the north/south ring-parity split (``ring_split``)
on GL grids with odd and even ring counts and on HEALPix, the parity
kernels' plain versions, ``fft_mode`` "fft" and "ct", ``m_block``,
``table_dtype``, the split's refusals, the options reaching the cut, floor
and point transforms, ASIS steps on a split model without the cut
decomposition, the m-sharded split transform (gloo processes), and the
native table engine with its disk cache."""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_workers as tpw
from torch_parity import (jax_mh_uniforms, jax_model_arrays, make_holey,
                          make_masked_healpix, n, port_model, t64)
from gibbssampler_tpu.harmonics import ell_mask_state, nstate
from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
from gibbssampler_tpu.inference import example_dl
from gibbssampler_tpu.inference import simulate_dataset as jax_simulate
from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
from gibbssampler_tpu.schemes import GibbsState as JaxState
from gibbssampler_tpu.sht import SHT as JaxSHT
from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl
from gibbssampler_tpu.sht import legendre as jax_legendre
from gibbssampler_tpu.sht.healpix import make_healpix_sht as jax_healpix
from gibbssampler_tpu.sht.lcore import grid_symmetric as jax_grid_symmetric
from gibbssampler_tpu.sht.grids import subgrid_rows as jax_subgrid_rows
from gibbssampler_tpu_torch.interop import model_from_numpy, state_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
from gibbssampler_tpu_torch.schemes import ASISGibbs
from gibbssampler_tpu_torch.sht import (SHT, PointSHT, gauss_legendre_grid,
                                        grid_symmetric, make_healpix_sht,
                                        make_sht, subgrid_rows)
from gibbssampler_tpu_torch.sht import legendre as tl
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

F64 = torch.float64
TOL = 1e-9


def _close(mine, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(mine), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _grid_pair(kind, lmax):
    """(JAX grid or None, port grid or None, HEALPix nside or None)."""
    if kind == "healpix":
        return None, None, 8
    nrings = None if kind == "gl-odd" else lmax + 2
    return (jax_gl(lmax, nrings=nrings), gauss_legendre_grid(lmax, nrings),
            None)


def _transforms(kind, lmax, **opts):
    """(JAX SHT, port SHT) of ``kind`` with the options ``opts``."""
    jg, tg, nside = _grid_pair(kind, lmax)
    if nside:
        return (jax_healpix(nside, lmax, dtype=jnp.float64, spin2=True,
                            **opts),
                make_healpix_sht(nside, lmax, dtype=F64, spin2=True,
                                 device="cpu", **opts))
    return (JaxSHT(jg, lmax, dtype=jnp.float64, spin2=True, **opts),
            SHT(tg, lmax, dtype=F64, spin2=True, device="cpu", **opts))


def _maps_shape(ts):
    return (ts.geo.npix,) if hasattr(ts, "geo") else (ts.nrings, ts.nphi)


# ---------------------------------------------------------------------------
# grid symmetry and the split transforms
# ---------------------------------------------------------------------------

def test_grid_symmetric_matches_jax():
    """GL with odd and even ring counts and HEALPix are equator-symmetric;
    a subset of rings, one ring and a shifted grid are not; a split asked
    for on those is quietly dense, as in the JAX package."""
    g = gauss_legendre_grid(10)
    thetas = [g.theta, gauss_legendre_grid(10, 12).theta,
              make_healpix_sht(4, 8, dtype=F64, device="cpu").geo.theta,
              g.theta[2:], g.theta[:1], g.theta + 0.01]
    got = [grid_symmetric(th) for th in thetas]
    assert got == [jax_grid_symmetric(th) for th in thetas]
    assert got == [True, True, True, False, False, False]
    rows = np.arange(2, 7)
    ts = SHT(subgrid_rows(g, rows), 10, dtype=F64, device="cpu",
             allow_aliasing=True, ring_split=True)
    js = JaxSHT(jax_subgrid_rows(jax_gl(10), rows), 10, dtype=jnp.float64,
                allow_aliasing=True, ring_split=True)
    assert ts.ring_split is js.ring_split is False
    assert tuple(ts.lam0.shape) == (11, 11, 5)


@pytest.mark.parametrize("kind", ["gl-odd", "gl-even", "healpix"])
def test_split_matches_jax_and_dense(kind):
    """The split transform against the JAX package's split transform and
    against the port's dense one: spin-0 and spin-2 synthesis, adjoint and
    analysis (the half-ring tables are those of the full grid's north
    rings, the equator row included when nrings is odd)."""
    lmax = 16
    js, ts = _transforms(kind, lmax, ring_split=True)
    _, td = _transforms(kind, lmax)
    assert ts.ring_split and js.ring_split and not td.ring_split
    assert (ts.nrh, ts.has_mid) == (js.nrh, js.has_mid)
    nh = js.nrh + js.has_mid
    assert tuple(ts.lam0.shape) == (lmax + 1, lmax + 1, nh)
    assert ts.lam_p2 is None and ts.lam_w is not None
    rng = np.random.default_rng(hash(kind) % 2 ** 32)
    ns, shp = nstate(lmax), _maps_shape(ts)
    x = rng.normal(size=(2, ns)) * ell_mask_state(lmax, 0)
    e, b = (rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2)
            for _ in range(2))
    f, q, u = (rng.normal(size=(2,) + shp) for _ in range(3))
    J = jnp.asarray
    for meth, args in [("synthesis_state", (x,)),
                       ("adjoint_synthesis_state", (f,)),
                       ("analysis_state", (f,)),
                       ("synthesis_spin2_state", (e, b)),
                       ("adjoint_synthesis_spin2_state", (q, u)),
                       ("analysis_spin2_state", (q, u))]:
        mine = getattr(ts, meth)(*map(t64, args))
        ref = getattr(js, meth)(*map(J, args))
        dense = getattr(td, meth)(*map(t64, args))
        if not isinstance(mine, tuple):
            mine, ref, dense = (mine,), (ref,), (dense,)
        for k, (a, r, d) in enumerate(zip(mine, ref, dense)):
            _close(a, r, f"{kind} {meth} [{k}] vs JAX")
            _close(a, n(d), f"{kind} {meth} [{k}] vs dense")


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("nrings", [17, 18])
def test_parity_plain_versions_match_jax_sym(nrings, flip):
    """``legendre_synth_par_plain`` / ``legendre_adj_par_plain`` on the
    port's half-ring table against the JAX package's ``_lsynth_stack_sym``
    / ``_ladj_stack_sym`` (with and without ``flip``) on its wedge-parity
    blocks (m_block 4: several blocks, odd and even block starts), the
    slab form against the matching rows, and the wrappers on CPU tensors
    taking the plain versions without a launch."""
    lmax, C = 15, 3
    L = lmax + 1
    js = JaxSHT(jax_gl(lmax, nrings=nrings), lmax, dtype=jnp.float64,
                ring_split=True, m_block=4)
    ts = SHT(gauss_legendre_grid(lmax, nrings), lmax, dtype=F64,
             device="cpu", ring_split=True, m_block=4)
    rng = np.random.default_rng(nrings + 2 * flip)
    g2 = rng.normal(size=(C, L, L)) * (np.arange(L)[None, None, :]
                                       >= np.arange(L)[None, :, None])
    gr = rng.normal(size=(C, nrings, L))
    ref_s = np.asarray(js._lsynth_stack_sym(js.lam0, jnp.asarray(g2), flip))
    ref_a = np.asarray(js._ladj_stack_sym(js.lam0, jnp.asarray(gr), flip))
    x = t64(g2).transpose(0, 1)                          # (m, C, l)
    gk = t64(gr).permute(2, 1, 0).contiguous()           # (m, r, C)
    lk.reset_launch_counts()
    syn = lk.legendre_synth_par(ts.lam0, x, nrings, flip)
    adj = lk.legendre_adj_par(ts.lam0, gk, flip)
    assert (lk.legendre_synth_par.launches, lk.legendre_adj_par.launches) \
        == (0, 0)
    _close(syn.permute(2, 1, 0), ref_s, "synthesis")
    _close(adj.transpose(0, 1), ref_a, "adjoint")
    ms = torch.tensor([9, 0, 4, 15, 7], dtype=torch.int32)
    rows = ms.long()
    lam_s = ts.lam0[rows].contiguous()
    syn_s = lk.legendre_synth_par(lam_s, x[rows], nrings, flip, ms)
    adj_s = lk.legendre_adj_par(lam_s, gk[rows].contiguous(), flip, ms)
    np.testing.assert_allclose(n(syn_s), n(syn[rows]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(n(adj_s), n(adj[rows]), rtol=0, atol=1e-12)


def test_parity_wrappers_refuse_mismatched_tables():
    """A half table whose ring count is not ceil(nr / 2) raises, on the
    CPU as on the card."""
    lam = torch.zeros((5, 5, 3), dtype=F64)
    with pytest.raises(ValueError):
        lk.legendre_synth_par(lam, torch.zeros((5, 2, 5), dtype=F64), 7)
    with pytest.raises(ValueError):
        lk.legendre_adj_par(lam, torch.zeros((5, 7, 2), dtype=F64))
    assert lk.legendre_synth_par(lam, torch.zeros((5, 2, 5), dtype=F64),
                                 6).shape == (5, 6, 2)


# ---------------------------------------------------------------------------
# fft_mode, m_block, table_dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fft", "ct"])
def test_fft_modes_match_jax(mode):
    """``fft_mode`` "fft" and "ct" against the JAX package's same mode on
    every public transform, spin 0 and 2 (GL lmax 64: nphi 130 = 13 x 10
    admits the "ct" factorization)."""
    lmax = 64
    js, ts = _transforms("gl-odd", lmax, fft_mode=mode)
    assert ts.fft_mode == js.fft_mode == mode
    assert (ts._ct is None) == (js._ct is None) == (mode != "ct")
    rng = np.random.default_rng(7)
    ns, shp = nstate(lmax), _maps_shape(ts)
    x = rng.normal(size=(ns,)) * ell_mask_state(lmax, 0)
    e, b = (rng.normal(size=(ns,)) * ell_mask_state(lmax, 2)
            for _ in range(2))
    f, q, u = (rng.normal(size=shp) for _ in range(3))
    J = jnp.asarray
    for meth, args in [("synthesis_state", (x,)),
                       ("analysis_state", (f,)),
                       ("adjoint_synthesis_state", (f,)),
                       ("synthesis_spin2_state", (e, b)),
                       ("analysis_spin2_state", (q, u)),
                       ("adjoint_synthesis_spin2_state", (q, u))]:
        mine = getattr(ts, meth)(*map(t64, args))
        ref = getattr(js, meth)(*map(J, args))
        for k, (a, r) in enumerate(zip(*(
                (v,) if not isinstance(v, tuple) else v
                for v in (mine, ref)))):
            _close(a, r, f"{mode} {meth} [{k}]")


def test_ct_falls_back_to_matmul_as_jax():
    """No useful factorization of nphi at lmax 8: "ct" quietly becomes
    "matmul" (tests/test_sht.py::test_ct_mode_fallback_small)."""
    ts = make_sht(8, dtype=F64, fft_mode="ct", device="cpu")
    js = JaxSHT(jax_gl(8), 8, fft_mode="ct")
    assert ts.fft_mode == js.fft_mode == "matmul" and ts._ct is None
    with pytest.raises(ValueError):
        make_sht(8, dtype=F64, fft_mode="dft", device="cpu")


@pytest.mark.parametrize("split", [False, True])
def test_m_block_leaves_results_unchanged(split):
    """``m_block`` is stored and changes nothing: every value gives the
    same transforms, bit for bit."""
    lmax = 12
    rng = np.random.default_rng(3)
    e, b = (t64(rng.normal(size=(2, nstate(lmax))) * ell_mask_state(lmax, 2))
            for _ in range(2))
    outs = []
    for mb in (0, 4, 128):
        ts = make_sht(lmax, dtype=F64, spin2=True, device="cpu", m_block=mb,
                      ring_split=split)
        assert ts.m_block == mb
        q, u = ts.synthesis_spin2_state(e, b)
        outs.append((q, u, *ts.adjoint_synthesis_spin2_state(q, u)))
    for o in outs[1:]:
        for a, r in zip(o, outs[0]):
            assert torch.equal(a, r)


def test_table_dtype_takes_the_compute_dtype_and_refuses_others():
    """None, the compute dtype or its name build the transform; so does
    every other pair the JAX package runs (``sht.lcore.TABLE_PAIRS``):
    bfloat16 or float16 tables under float32 compute, bfloat16, float16 or
    float32 tables under float64, and float64 tables under float32, each as
    a torch dtype, a name or a numpy dtype, on every transform that takes
    the option, with lam0 stored in the table dtype; a pair that no path of
    the package supports (an integer or 8-bit float table, a float32 table
    under float16 compute) raises NotImplementedError."""
    import ml_dtypes
    from gibbssampler_tpu_torch.sht.lcore import TABLE_PAIRS
    for td in (None, F64, "float64", np.dtype("float64")):
        assert make_sht(6, dtype=F64, table_dtype=td,
                        device="cpu").table_dtype == F64
    assert set(TABLE_PAIRS) == {
        (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
        (torch.bfloat16, F64), (torch.float16, F64), (torch.float32, F64),
        (F64, torch.float32)}
    numpy_of = {torch.bfloat16: np.dtype(ml_dtypes.bfloat16),
                torch.float16: np.float16, torch.float32: np.float32,
                F64: np.dtype("float64")}
    for want, cd in TABLE_PAIRS:
        for td in (want, str(want)[6:], numpy_of[want]):
            for ts in (make_sht(6, dtype=cd, table_dtype=td, device="cpu"),
                       make_healpix_sht(2, 4, dtype=cd, table_dtype=td,
                                        device="cpu"),
                       PointSHT(np.array([1.0]), np.zeros((1, 2)),
                                np.ones((1, 2)), 4, dtype=cd, device="cpu",
                                table_dtype=td)):
                assert ts.table_dtype == want and ts.lam0.dtype == want
                assert ts.dtype == cd
    for dtype, bad in ((F64, torch.int32), (torch.float32, "int8"),
                       (F64, "float8_e4m3fn"), (torch.float16, "float32"),
                       (torch.float32, "complex64")):
        with pytest.raises(NotImplementedError):
            make_sht(6, dtype=dtype, table_dtype=bad, device="cpu")
        with pytest.raises(NotImplementedError):
            make_healpix_sht(2, 4, dtype=dtype, table_dtype=bad,
                             device="cpu")
        with pytest.raises(NotImplementedError):
            PointSHT(np.array([1.0]), np.zeros((1, 2)), np.ones((1, 2)), 4,
                     dtype=dtype, device="cpu", table_dtype=bad)


# ---------------------------------------------------------------------------
# refusals under the split
# ---------------------------------------------------------------------------

def _refusals(sht, J, st, sel, j_idx):
    """The calls the split refuses, each a thunk."""
    g = sht._state_grids(st)
    return {
        "_spin2_stacks": lambda: sht._spin2_stacks(st, st),
        "_lsynth_stack_binned": lambda: sht._lsynth_stack_binned(
            sht.lam0, g, sel),
        "_lsel_F": lambda: sht._lsel_F(sht.lam0, g, j_idx, None),
        "ring_cs_lsel_spin0": lambda: sht.ring_cs_lsel_spin0(st, j_idx,
                                                             None),
        "ring_cs_lsel_spin2": lambda: sht.ring_cs_lsel_spin2(st, st, j_idx,
                                                             None),
        "ring_cs_lsel_spin2_grids": lambda: sht.ring_cs_lsel_spin2_grids(
            g, -1.0, -1.0, j_idx, None),
        "synthesis_spin2_state_lsel": lambda: sht.synthesis_spin2_state_lsel(
            st, st, sel),
        "synthesis_state_lsel": lambda: sht.synthesis_state_lsel(st, sel),
    }


def test_split_refusals_match_jax():
    """Every ell-selected, binned or stack-sharing call of a split
    transform raises NotImplementedError with the JAX package's message."""
    lmax = 8
    js, ts = _transforms("gl-odd", lmax, ring_split=True)
    st = np.random.default_rng(0).normal(size=(1, nstate(lmax)))
    sel = np.eye(lmax + 1)[2:5]
    j_idx = np.array([2, 3, 4])
    mine = _refusals(ts, t64, t64(st), sel, j_idx)
    ref = _refusals(js, jnp.asarray, jnp.asarray(st), jnp.asarray(sel),
                    j_idx)
    for name, call in mine.items():
        with pytest.raises(NotImplementedError) as got:
            call()
        with pytest.raises(NotImplementedError) as want:
            ref[name]()
        assert str(got.value) == str(want.value), name
    with pytest.raises(NotImplementedError):
        ts.lsel_table(ts.lam0, j_idx)


# ---------------------------------------------------------------------------
# the options of derived transforms
# ---------------------------------------------------------------------------

def _gl_holey(**opts):
    """The holey GL dataset (floor + sparse split) on a transform built
    with ``opts``: the JAX cut model and the port's."""
    jm, _, _ = make_holey(spin=2, lmax=16)
    js = JaxSHT(jm.sht.grid, 16, dtype=jnp.float64, spin2=True, **opts)
    jc = jax_cut(dataclasses.replace(jm, sht=js), sparse_split=True)
    arrays = {**jax_model_arrays(jm), **opts}
    tc = with_cut_decomposition(model_from_numpy(arrays, device="cpu"),
                                sparse_split=True)
    return jc, tc


def test_options_reach_the_cut_floor_and_point_transforms():
    """The cut and point transforms take the full transform's fft_mode,
    table_dtype and m_block and are dense (ring_split False), as in the
    JAX package; the HEALPix floor keeps fft_mode "matmul"; a split full
    transform still gives dense cut tables, and the m-domain engines'
    eligibility reads the cut's ring_split."""
    jc, tc = _gl_holey(fft_mode="fft", m_block=8, ring_split=True)
    assert tc.sht.ring_split and jc.sht.ring_split
    for attr in ("fft_mode", "m_block", "ring_split"):
        assert getattr(tc.cut_sht, attr) == getattr(jc.cut_sht, attr), attr
    assert tc.cut_sht.fft_mode == "fft" and not tc.cut_sht.ring_split
    assert tc.sp_sht.m_block == jc.sp_sht.m_block == 8
    assert not tc.sp_sht.ring_split
    assert tc.cut_sht.table_dtype == tc.sp_sht.table_dtype == F64
    hm, _, _ = make_masked_healpix(spin=2, nside=8)
    th = with_cut_decomposition(model_from_numpy(
        {**jax_model_arrays(hm), "m_block": 16, "ring_split": True},
        device="cpu"))
    assert th.sht.ring_split and th.cut_sht.fft_mode == "matmul"
    assert th.cut_sht.m_block == 16 and not th.cut_sht.ring_split
    assert th.cut_w_uniform and tcs._mdomain_eligible(th)
    split_cut = types.SimpleNamespace(ring_split=True, nphi=th.cut_sht.nphi)
    assert not tcs._mdomain_eligible(types.SimpleNamespace(
        cut_w_uniform=True, cut_sht=split_cut, lmax=th.lmax))


# ---------------------------------------------------------------------------
# the scheme on the split path
# ---------------------------------------------------------------------------

ASIS_LMAX = 12
ASIS_BINS = [np.arange(2, ASIS_LMAX + 2),
             np.array([2, 3, 4, 5, 6, 7, 8, 10, 11, 13])]
ASIS_BLOCKS = [[(0, 11)], [(0, 3)] + [(i, i + 1) for i in range(3, 9)]]


def test_asis_steps_on_a_split_model_without_cut_match_jax():
    """Three ASISGibbs iterations of 3 chains on a band-masked spin-2 model
    without the cut decomposition (bench.py's BENCH_CUT=0) whose transform
    is ring-split: the JAX scheme's vmapped step and the port's batched
    step, fed the same pools and variates, agree to 1e-9 at every
    iteration; the accepts are equal."""
    lmax, nch = ASIS_LMAX, 3
    grid = jax_gl(lmax)
    lat = np.abs(np.pi / 2 - grid.theta)
    mask = np.broadcast_to((lat > 0.3).astype(np.float64)[:, None],
                           (grid.nrings, grid.nphi))
    fields = np.stack([example_dl(lmax, "ee", amp=10.0),
                       example_dl(lmax, "bb", amp=10.0)])
    js = JaxSHT(grid, lmax, dtype=jnp.float64, spin2=True, ring_split=True)
    jm, _ = jax_simulate(jax.random.PRNGKey(0), lmax, spin=2,
                         dl_fields=fields, noise_sigma2=0.5,
                         fwhm_radians=0.05, mask=mask, dtype=jnp.float64,
                         sht=js)
    tm = model_from_numpy({**jax_model_arrays(jm), "ring_split": True},
                          device="cpu")
    assert tm.sht.ring_split and not tm.has_cut
    dl0 = [np.array([f[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])])
           for f, b in zip(fields, ASIS_BINS)]
    sig = [0.3 * d for d in dl0]
    kw = dict(n_iter_mh=1, cr_method="aux_mala",
              cr_options={"n_gibbs": 1, "tau": 0.02})
    jsch = JaxASIS(jm, ASIS_BINS, ASIS_BLOCKS, sig, **kw)
    tsch = ASISGibbs(tm, ASIS_BINS, ASIS_BLOCKS, sig, **kw)
    jstep = jax.jit(jax.vmap(jsch.step))
    dls = tuple(np.tile(d, (nch, 1)) for d in dl0)
    var = np.asarray(jax.vmap(jsch.var_cls)(tuple(map(jnp.asarray, dls))))
    s0 = np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(map(jnp.asarray, dls)))
    tstate = state_from_numpy(s0, dls, device="cpu")
    ell = jnp.arange(lmax + 1, dtype=jnp.float64)
    alphas = []
    for b in ASIS_BINS:
        a = jax_bin_sum(2.0 * ell + 1.0, b, lmax) / 2.0 - 1.0
        alphas.append(jnp.where(a <= 0, 1.0, a))
    ntot = sum(len(b) - 1 for b in ASIS_BINS)
    nblocks = sum(map(len, ASIS_BLOCKS))
    rng = np.random.default_rng(1)
    accepts = []
    for it in range(3):
        pool = {"state": rng.normal(size=(nch, 2, 2, nstate(lmax))),
                "aux": rng.normal(size=(nch, 1) + tuple(jm.noise.tau.shape))}
        keys = jax.random.split(jax.random.PRNGKey(200 + it), nch)
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
            _close(mine, ref, f"iteration {it} {what}")
        np.testing.assert_array_equal(n(tinfo["cr_accept"]),
                                      np.asarray(jinfo["cr_accept"]))
        for f in range(2):
            np.testing.assert_array_equal(n(tinfo["mh_accept"][f]),
                                          np.asarray(jinfo["mh_accept"][f]))
            accepts.append(n(tinfo["mh_accept"][f]).ravel())
    assert 0.0 < np.concatenate(accepts).mean() < 1.0


# ---------------------------------------------------------------------------
# the m-sharded split transform
# ---------------------------------------------------------------------------

def test_m_sharded_split_transforms_match_unsharded(tmp_path):
    """``shard_sht`` of the split GL (odd nrings) and HEALPix transforms
    over two gloo processes: each holds its rows of the half-ring tables
    (lam0, W, X), and its spin-0 and spin-2 synthesis, adjoint and
    analysis equal the JAX package's unsharded split transform (<= 1e-12)
    on both processes."""
    lmax = 9
    rng = np.random.default_rng(11)
    ns = nstate(lmax)
    jss = {"gl": JaxSHT(jax_gl(lmax), lmax, dtype=jnp.float64, spin2=True,
                        ring_split=True),
           "healpix": jax_healpix(8, lmax, dtype=jnp.float64, spin2=True,
                                  ring_split=True)}
    inputs = {}
    for kind, js in jss.items():
        shp = (js.geo.npix,) if kind == "healpix" else (js.grid.nrings,
                                                         js.grid.nphi)
        inputs[kind] = (rng.normal(size=(2, ns)) * ell_mask_state(lmax, 0),
                        *(rng.normal(size=(2,) + shp) for _ in range(1)),
                        *(rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2)
                          for _ in range(2)),
                        *(rng.normal(size=(2,) + shp) for _ in range(2)))
    res = tpw.spawn(tpw.split_transforms, 2, tmp_path, lmax, inputs)
    J = jnp.asarray
    for kind, js in jss.items():
        x, f, e, b, q, u = inputs[kind]
        syn_q, syn_u = js.synthesis_spin2_state(J(e), J(b))
        adj_e, adj_b = js.adjoint_synthesis_spin2_state(J(q), J(u))
        ref = {"syn0": js.synthesis_state(J(x)),
               "adj0": js.adjoint_synthesis_state(J(f)),
               "ana0": js.analysis_state(J(f)),
               "syn_q": syn_q, "syn_u": syn_u, "adj_e": adj_e,
               "adj_b": adj_b}
        nh = js.nrh + js.has_mid
        for out in res:
            assert (out[f"{kind}_nh"] == nh).all()
            assert out[f"{kind}_rows"].tolist() == [len(out[f"{kind}_ms"])] * 3
            for k, want in ref.items():
                np.testing.assert_allclose(out[f"{kind}_{k}"],
                                           np.asarray(want), rtol=0,
                                           atol=1e-12, err_msg=f"{kind} {k}")
        assert sorted(np.concatenate([o[f"{kind}_ms"] for o in res])
                      .tolist()) == list(range(lmax + 1))


# ---------------------------------------------------------------------------
# the native table engine and the disk cache
# ---------------------------------------------------------------------------

def test_native_tables_match_numpy_and_jax():
    """The native engine builds and loads here (g++ is present), and its
    Legendre and Wigner-d tables at lmax 64 equal the numpy recurrences
    and the JAX package's tables to 1e-12."""
    lmax = 64
    theta = jax_gl(lmax).theta
    x = np.cos(theta)
    assert tl.native_engine() is not None
    lib = tl.native_engine()
    L = lmax + 1
    leg = np.empty((L, L, x.size))
    lib.gs_legendre_table(lmax, x.size, np.ascontiguousarray(x), leg)
    np.testing.assert_allclose(leg, tl._legendre_table_np(lmax, x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(leg, jax_legendre.legendre_table(lmax, x),
                               rtol=0, atol=1e-12)
    for s in (-2, 2):
        wig = np.empty((L, L, x.size))
        lib.gs_wigner_d_table(lmax, s, x.size, np.ascontiguousarray(theta),
                              wig)
        np.testing.assert_allclose(wig, tl._wigner_d_table_np(lmax, s, theta),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            wig, jax_legendre.wigner_d_table(lmax, s, theta), rtol=0,
            atol=1e-12)


def test_table_cache_round_trip(tmp_path, monkeypatch):
    """Under a temporary XDG_CACHE_HOME the first build writes each table
    under the JAX package's key (kind, lmax, extra, sha1 of the nodes),
    and the second reads it back, equal, without computing; with
    ``CACHE = False`` nothing is read or written."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(tl, "CACHE", True)
    x = np.cos(np.linspace(0.2, 2.9, 7))
    a = tl.legendre_table(10, x)
    w = tl.wigner_d_table(10, 2, np.arccos(x))
    files = sorted(p.name for p in
                   (tmp_path / "gibbssampler_tpu_torch" / "tables").iterdir())
    assert len(files) == 2
    assert files[0].startswith("leg_10_0_") and files[1].startswith("wig_10_2_")

    def refuse(*args):
        raise AssertionError("computed, not read from the cache")
    monkeypatch.setattr(tl, "native_engine", refuse)
    monkeypatch.setattr(tl, "_legendre_table_np", refuse)
    np.testing.assert_array_equal(tl.legendre_table(10, x), a)
    np.testing.assert_array_equal(tl.wigner_d_table(10, 2, np.arccos(x)), w)
    monkeypatch.setattr(tl, "CACHE", False)
    with pytest.raises(AssertionError, match="computed"):
        tl.legendre_table(10, x)
