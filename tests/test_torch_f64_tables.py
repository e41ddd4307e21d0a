"""Float64 compute on narrower tables (bfloat16 or float32 Legendre tables,
a float64 batch) in the port against the JAX package's (CPU, x64 on, one
torch thread): the four Legendre contractions' plain versions, the GL,
HEALPix and point-set transforms with every rounding point of their
azimuthal stages, the ell-selected synthesis, the table engine's W tables
and a fixed number of ``cg_cr`` iterations on the band cut model.

Each JAX call runs under ``jax.jit``, with the transform closed over (its
tables become constants of the compiled program), as the JAX package runs
the path itself: the CPU runtime has no eager bfloat16 dot.

The comparisons are at 1e-12 of max|ref|, float64 accumulation noise: in
both packages each data operand is rounded to the table dtype before its
product, the product of two table-dtype values is exact in float64, and
the products are summed in float64.  A contraction that skips a rounding,
or rounds at another place, misses that by the size of the table dtype's
rounding (some 1e-3 for bfloat16, 1e-8 for float32), and
``test_tolerance_discriminates`` shows it does.  The ``cg_cr`` comparison
is at 1e-9, the CG family's tolerance in tests/test_torch_cg.py: 20
iterations of a solve compound the summation-order differences."""

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from torch_parity import jax_model_arrays, n, tri_table
from gibbssampler_tpu.harmonics import ell_mask_state, nstate
from gibbssampler_tpu.sht import SHT as JaxSHT
from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl
from gibbssampler_tpu.sht.healpix import make_healpix_sht as jax_healpix
from gibbssampler_tpu.sht.points import PointSHT as JaxPointSHT
from gibbssampler_tpu_torch.sht import (SHT, PointSHT, gauss_legendre_grid,
                                        make_healpix_sht, make_sht)
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

F64 = torch.float64
TOL = 1e-12
# the table dtypes: (torch, JAX)
TDS = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
       "float32": (torch.float32, jnp.float32)}
# rounds to 1.0 through float32 (JAX's and torch's conversion) and to
# 1.0078125 in one rounding to bfloat16
DOUBLE_ROUNDING = 1.0 + 2.0 ** -8 + 2.0 ** -30


@pytest.fixture(scope="module", autouse=True)
def _x64_on():
    """The JAX package's float64 programs."""
    jax.config.update("jax_enable_x64", True)
    yield


def _err(mine, ref) -> float:
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(n(mine).astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def _close(mine, ref, what, tol=TOL):
    err = _err(mine, ref)
    assert err <= tol, f"{what}: {err:.3g} max|ref| > {tol}"


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _jit(fn, *args):
    """``fn(*args)`` compiled (``fn`` closes over the JAX transform)."""
    return jax.jit(fn)(*args)


# ---------------------------------------------------------------------------
# the four contractions
# ---------------------------------------------------------------------------

def _inputs(L, nr, C, seed):
    """A table, a batch x and a batch g, with the double-rounding value in
    each batch."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(L, C, L))
    g = rng.normal(size=(L, nr, C))
    x[L - 1, 0, L - 1] = x[1, C - 1, 2] = DOUBLE_ROUNDING
    g[L - 1, 0, C - 1] = DOUBLE_ROUNDING
    return tri_table(L, nr, seed), x, g


def _parity(L, ms):
    """(even, odd) masks of l - m over (M, L, 1), m = ms."""
    odd = (np.arange(L)[None, :] - np.asarray(ms)[:, None]) % 2
    return (1 - odd)[:, :, None].astype(np.float64), odd[:, :, None]


def _jax_tri(jtd):
    """JAX's dense contractions: table-dtype operands, float64 sums."""
    @jax.jit
    def fn(lam, x, g):
        return (jnp.einsum("mlr,mcl->mrc", lam, x.astype(jtd),
                           preferred_element_type=jnp.float64),
                jnp.einsum("mlr,mrc->mcl", lam, g.astype(jtd),
                           preferred_element_type=jnp.float64))
    return fn


def _jax_par(jtd):
    """The JAX package's split contractions (lcore ``_lsynth_stack_sym`` /
    ``_ladj_stack_sym``) with the parity masks folded into the tables:
    synthesis E + O north, f (E - O) south; the adjoint folds the south
    rows in float64, then rounds U and V."""
    @jax.jit
    def fn(lamE, lamO, x, g, f):
        nh = lamE.shape[2]
        xb = x.astype(jtd)
        E = jnp.einsum("mlr,mcl->mrc", lamE, xb,
                       preferred_element_type=jnp.float64)
        O = jnp.einsum("mlr,mcl->mrc", lamO, xb,
                       preferred_element_type=jnp.float64)
        nr = g.shape[1]
        south = (f * (E - O))[:, : nr - nh][:, ::-1]
        gn = g[:, :nh]
        gs = jnp.zeros_like(gn).at[:, : nr - nh].set(g[:, nh:][:, ::-1]) * f
        U, V = (gn + gs).astype(jtd), (gn - gs).astype(jtd)
        return (jnp.concatenate([E + O, south], axis=1),
                jnp.einsum("mlr,mrc->mcl", lamE, U,
                           preferred_element_type=jnp.float64)
                + jnp.einsum("mlr,mrc->mcl", lamO, V,
                             preferred_element_type=jnp.float64))
    return fn


@pytest.mark.parametrize("td", sorted(TDS))
@pytest.mark.parametrize("L,nr,C,slab", [(17, 13, 5, False),
                                          (33, 19, 24, False),
                                          (33, 19, 24, True)])
def test_dense_plain_versions_match_jax(td, L, nr, C, slab):
    """legendre_{synth,adj}_tri on a narrow table and a float64 batch
    (their plain versions, the CPU path of the wrappers) against JAX's
    einsum of table-dtype operands with a float64 result; full table and a
    slab of every third row."""
    ttd, jtd = TDS[td]
    lam, x, g = _inputs(L, nr, C, L + nr)
    ms = np.arange(1, L, 3) if slab else np.arange(L)
    lt = torch.as_tensor(lam[ms]).to(ttd)
    msk = torch.as_tensor(ms, dtype=torch.int32) if slab else None
    out_s = lk.legendre_synth_tri(lt, _t(x[ms]), msk)
    out_a = lk.legendre_adj_tri(lt, _t(g[ms]), msk)
    assert out_s.dtype == out_a.dtype == F64
    ref_s, ref_a = _jax_tri(jtd)(jnp.asarray(lam[ms], jtd), x[ms], g[ms])
    _close(out_s, ref_s, "synth")
    _close(out_a, ref_a, "adj")


@pytest.mark.parametrize("td", sorted(TDS))
@pytest.mark.parametrize("L,nr,C,flip,slab", [
    (17, 13, 5, False, False), (33, 19, 24, True, False),
    (33, 18, 24, False, True), (33, 19, 24, True, True)])
def test_parity_plain_versions_match_jax(td, L, nr, C, flip, slab):
    """legendre_{synth,adj}_par on a narrow half table (odd nr: the
    equator row; even: none), flip and not, full and slab, against the JAX
    package's split contractions, whose adjoint rounds the float64 fold.
    One fold is the double-rounding value."""
    ttd, jtd = TDS[td]
    nh = (nr + 1) // 2
    lam, x, _ = _inputs(L, nh, C, L + nr)
    g = np.random.default_rng(nr).normal(size=(L, nr, C))
    ms = np.arange(2, L, 3) if slab else np.arange(L)
    # north ring 0 and its mirror fold to DOUBLE_ROUNDING at row ms[0]
    south = 1.0 / 1024.0
    g[ms[0], 0, 1] = DOUBLE_ROUNDING - (-south if flip else south)
    g[ms[0], nr - 1, 1] = south
    lt = torch.as_tensor(lam[ms]).to(ttd)
    msk = torch.as_tensor(ms, dtype=torch.int32) if slab else None
    out_s = lk.legendre_synth_par(lt, _t(x[ms]), nr, flip, msk)
    out_a = lk.legendre_adj_par(lt, _t(g[ms]), flip, msk)
    ev, od = _parity(L, ms)
    lj = np.asarray(jnp.asarray(lam[ms], jtd).astype(jnp.float64))
    ref_s, ref_a = _jax_par(jtd)(jnp.asarray(lj * ev, jtd),
                                 jnp.asarray(lj * od, jtd), x[ms], g[ms],
                                 -1.0 if flip else 1.0)
    _close(out_s, ref_s, "synth par")
    _close(out_a, ref_a, "adj par")


def test_batch_rounds_through_float32():
    """A float64 batch value bound for bfloat16 is rounded through float32
    by the JAX package and by the plain versions (the kernels do the same,
    tests/test_torch_legendre_kernels.py): 1 + 2^-8 + 2^-30 becomes 1, not
    the 1 + 2^-7 of one rounding, in a product and in a parity fold."""
    v = np.array([DOUBLE_ROUNDING])
    # above the midpoint 1 + 2^-8 of bfloat16's neighbours 1 and 1 + 2^-7
    # (one rounding: 1 + 2^-7), but float32 rounds it onto the midpoint,
    # which then rounds to the even neighbour, 1
    assert 1.0 + 2.0 ** -8 < DOUBLE_ROUNDING < 1.0 + 2.0 ** -7
    assert float(np.float32(DOUBLE_ROUNDING)) == 1.0 + 2.0 ** -8
    assert float(jax.jit(lambda a: a.astype(jnp.bfloat16)
                         .astype(jnp.float64))(v)[0]) == 1.0
    assert float(v.astype(ml_dtypes.bfloat16)[0]) == 1.0
    lam = torch.ones((1, 1, 1), dtype=torch.bfloat16)
    assert float(lk.legendre_synth_tri(lam, _t(v).reshape(1, 1, 1))) == 1.0
    g = _t([DOUBLE_ROUNDING - 2.0 ** -10, 2.0 ** -10]).reshape(1, 2, 1)
    assert float(lk.legendre_adj_par(lam, g)) == 1.0


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

_METHODS = ("synthesis_state", "adjoint_synthesis_state", "analysis_state",
            "synthesis_spin2_state", "adjoint_synthesis_spin2_state",
            "analysis_spin2_state")


def _state_inputs(lmax, maps_shape, seed):
    rng = np.random.default_rng(seed)
    ns = nstate(lmax)
    st = lambda spin: rng.normal(size=(2, ns)) * ell_mask_state(lmax, spin)
    return (st(0), rng.normal(size=(2,) + maps_shape), st(2), st(2),
            *(rng.normal(size=(2,) + maps_shape) for _ in range(2)))


def _compare_transforms(js, ts, maps_shape, what):
    x, f, e, b, q, u = _state_inputs(ts.lmax, maps_shape, 11)
    ref = _jit(lambda x, f, e, b, q, u: (
        js.synthesis_state(x), js.adjoint_synthesis_state(f),
        js.analysis_state(f), js.synthesis_spin2_state(e, b),
        js.adjoint_synthesis_spin2_state(q, u),
        js.analysis_spin2_state(q, u)), x, f, e, b, q, u)
    args = {"synthesis_state": (x,), "adjoint_synthesis_state": (f,),
            "analysis_state": (f,), "synthesis_spin2_state": (e, b),
            "adjoint_synthesis_spin2_state": (q, u),
            "analysis_spin2_state": (q, u)}
    for meth, r in zip(_METHODS, ref):
        mine = getattr(ts, meth)(*map(_t, args[meth]))
        mine = mine if isinstance(mine, tuple) else (mine,)
        r = r if isinstance(r, tuple) else (r,)
        for k, (a, rr) in enumerate(zip(mine, r)):
            assert a.dtype == F64
            _close(a, rr, f"{what} {meth}[{k}]")


@pytest.mark.parametrize("td", sorted(TDS))
@pytest.mark.parametrize("lmax,split,mode", [
    (16, False, "matmul"), (16, True, "matmul"), (31, False, "ct"),
    (31, True, "ct")])
def test_sht_matches_jax(td, lmax, split, mode):
    """GL ``SHT`` spin 0 and 2, synthesis, adjoint and analysis, with
    narrow tables under float64 compute: dense and split (odd ring count:
    the equator row stays float64, as in the JAX package), "matmul" and
    "ct" (lmax 31: nphi 64 admits the factorization)."""
    ttd, jtd = TDS[td]
    grid = jax_gl(lmax)
    js = JaxSHT(grid, lmax, dtype=jnp.float64, spin2=True, fft_mode=mode,
                table_dtype=jtd, ring_split=split)
    ts = SHT(gauss_legendre_grid(lmax), lmax, dtype=F64, spin2=True,
             device="cpu", fft_mode=mode, table_dtype=td, ring_split=split)
    assert ts.fft_mode == js.fft_mode == mode and ts.ring_split == split
    assert ts.table_dtype == ttd
    _compare_transforms(js, ts, (grid.nrings, grid.nphi),
                        f"GL {lmax} {mode} split={split}")


@pytest.mark.parametrize("td", sorted(TDS))
@pytest.mark.parametrize("layout,split", [("ring", False), ("padded", False),
                                          ("padded", True)])
def test_healpix_matches_jax(td, layout, split):
    """``HealpixSHT`` at nside 8, lmax 16, with narrow tables and trig
    matrices under float64 compute, in the "ring" and "padded" layouts,
    dense and split."""
    ttd, jtd = TDS[td]
    js = jax_healpix(8, 16, dtype=jnp.float64, spin2=True, layout=layout,
                     table_dtype=jtd, ring_split=split)
    ts = make_healpix_sht(8, 16, dtype=F64, spin2=True, layout=layout,
                          device="cpu", table_dtype=ttd, ring_split=split)
    _compare_transforms(js, ts, (ts.npix_layout,), f"HEALPix {layout}")


@pytest.mark.parametrize("td", sorted(TDS))
def test_points_match_jax(td):
    """``PointSHT`` values and adjoints, spin 0 and 2, and the flat-slot
    per-bin values ``values_flat_spin0_gsel`` / ``values_flat_spin2_gsel``
    with and without a segment matrix, with narrow tables under float64
    compute."""
    ttd, jtd = TDS[td]
    lmax = 16
    rng = np.random.default_rng(4)
    nrows, p = 6, 5
    theta = np.sort(rng.uniform(0.2, 2.9, nrows))
    phi = rng.uniform(0, 2 * np.pi, (nrows, p))
    valid = (rng.uniform(size=(nrows, p)) < 0.8).astype(np.float64)
    valid[:, 0] = 1.0
    js = JaxPointSHT(theta, phi, valid, lmax, dtype=jnp.float64, spin2=True,
                     table_dtype=jtd)
    ts = PointSHT(theta, phi, valid, lmax, dtype=F64, spin2=True,
                  device="cpu", table_dtype=td)
    ns = nstate(lmax)
    x, e, b = (rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2)
               for _ in range(3))
    f, q, u = (rng.normal(size=(2, nrows, p)) for _ in range(3))
    ref = _jit(lambda x, f, e, b, q, u: (
        (js.synthesis_state(x),), (js.adjoint_synthesis_state(f),),
        js.synthesis_spin2_state(e, b),
        js.adjoint_synthesis_spin2_state(q, u)), x, f, e, b, q, u)
    mine = ((ts.synthesis_state(_t(x)),), (ts.adjoint_synthesis_state(_t(f)),),
            ts.synthesis_spin2_state(_t(e), _t(b)),
            ts.adjoint_synthesis_spin2_state(_t(q), _t(u)))
    for k, (a, r) in enumerate(zip(mine, ref)):
        for i, (aa, rr) in enumerate(zip(a, r)):
            _close(aa, rr, f"points [{k}][{i}]")
    j_idx = np.array([3, 5, 6, 9, 12, 16])
    seg = np.zeros((6, 3))
    seg[np.arange(6), [0, 0, 1, 1, 2, 2]] = 1.0
    gsel = rng.normal(size=(2, 2, lmax + 1, 6))
    for sg in (None, seg):
        r0 = _jit(lambda g: js.values_flat_spin0_gsel(g, j_idx, sg), gsel)
        _close(ts.values_flat_spin0_gsel(_t(gsel), j_idx, sg), r0,
               f"flat spin0 seg={sg is not None}")
        for sp, sm in ((-1.0, -1.0), (1.0, -1.0)):
            r2 = _jit(lambda g: js.values_flat_spin2_gsel(
                g, sp, sm, j_idx, sg), gsel)
            for a, r in zip(ts.values_flat_spin2_gsel(_t(gsel), sp, sm,
                                                      j_idx, sg), r2):
                _close(a, r, f"flat spin2 {sp} {sm} seg={sg is not None}")


@pytest.mark.parametrize("td", sorted(TDS))
def test_lsel_matches_jax(td):
    """``_lsel_F`` through ``ring_cs_lsel_spin0`` / ``ring_cs_lsel_spin2``
    on a GL transform with narrow tables under float64 compute, with and
    without ``seg``: the grid rounded, the product formed in the table
    dtype, the segment sums in float64."""
    ttd, jtd = TDS[td]
    lmax = 16
    js = JaxSHT(jax_gl(lmax), lmax, dtype=jnp.float64, spin2=True,
                table_dtype=jtd)
    ts = make_sht(lmax, dtype=F64, spin2=True, device="cpu", table_dtype=td)
    rng = np.random.default_rng(6)
    ns = nstate(lmax)
    x, e, b = (rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2)
               for _ in range(3))
    j_idx = np.array([2, 4, 5, 8, 11, 15, 16])
    seg = np.zeros((7, 3))
    seg[np.arange(7), [0, 0, 1, 1, 1, 2, 2]] = 1.0
    for sg in (None, seg):
        r0 = _jit(lambda x: js.ring_cs_lsel_spin0(x, j_idx, sg), x)
        for a, r in zip(ts.ring_cs_lsel_spin0(_t(x), j_idx, sg), r0):
            _close(a, r, f"lsel spin0 seg={sg is not None}")
        r2 = _jit(lambda e, b: js.ring_cs_lsel_spin2(e, b, j_idx, sg), e, b)
        m2 = ts.ring_cs_lsel_spin2(_t(e), _t(b), j_idx, sg)
        for (a1, a2), (r1, r2_) in zip(m2, r2):
            _close(a1, r1, f"lsel spin2 seg={sg is not None}")
            _close(a2, r2_, f"lsel spin2 seg={sg is not None}")


# ---------------------------------------------------------------------------
# the tolerance, and the tables
# ---------------------------------------------------------------------------

def test_tolerance_discriminates():
    """The bfloat16 comparisons above, with the batch left unrounded (the
    plain versions contracting the float64 batch with the widened table),
    miss the tolerance by far: the dense kernels' comparison, the Legendre
    stage of the spin-0 synthesis, and the whole spin-0 adjoint."""
    lmax = 16
    ttd, jtd = TDS["bfloat16"]
    js = JaxSHT(jax_gl(lmax), lmax, dtype=jnp.float64, table_dtype=jtd)
    ts = make_sht(lmax, dtype=F64, device="cpu", table_dtype=ttd)
    x, f = _state_inputs(lmax, (ts.nrings, ts.nphi), 3)[:2]
    g2 = np.asarray(_jit(lambda x: js._state_grids(x), x))
    lam, xk, gk = _inputs(17, 13, 5, 30)
    refs = (_jax_tri(jtd)(jnp.asarray(lam, jtd), xk, gk)
            + (_jit(lambda g: js._lsynth_stack(js.lam0, g), g2),
               _jit(lambda f: js.adjoint_synthesis_state(f), f)))
    lt = torch.as_tensor(lam).to(ttd)

    def mine():
        return (lk.legendre_synth_tri(lt, _t(xk)),
                lk.legendre_adj_tri(lt, _t(gk)),
                ts._lsynth_stack(ts.lam0, _t(g2)),
                ts.adjoint_synthesis_state(_t(f)))

    for a, r in zip(mine(), refs):
        _close(a, r, "port")
    unrounded = {
        "legendre_synth_tri_plain": lambda lam, b, ms=None: torch.einsum(
            "mlr,mcl->mrc", lam.to(b.dtype), b),
        "legendre_adj_tri_plain": lambda lam, b, ms=None: torch.einsum(
            "mlr,mrc->mcl", lam.to(b.dtype), b)}
    orig = {k: getattr(lk, k) for k in unrounded}
    try:
        for k, fn in unrounded.items():
            setattr(lk, k, fn)
        errs = [_err(a, r) for a, r in zip(mine(), refs)]
    finally:
        for k, fn in orig.items():
            setattr(lk, k, fn)
    assert min(errs) > 1e6 * TOL, errs


@pytest.mark.parametrize("td", sorted(TDS))
def test_tables_are_narrow(td):
    """``make_sht(..., dtype=float64, table_dtype=td)`` stores lam0,
    lam_p2 / lam_m2 (dense) and lam_w / lam_x (split) in the table dtype,
    at a quarter (bfloat16) or half (float32) of the float64 transform's
    bytes, the split's float64 equator rows apart; the DFT matrices hold
    table-dtype values in float64."""
    ttd = TDS[td][0]
    for split in (False, True):
        kw = dict(dtype=F64, spin2=True, device="cpu", ring_split=split)
        nt = make_sht(16, table_dtype=td, **kw)
        f64 = make_sht(16, **kw)
        names = ("lam0", "lam_w", "lam_x") if split else ("lam0", "lam_p2",
                                                           "lam_m2")
        for name in names:
            a, b = getattr(nt, name), getattr(f64, name)
            assert a.dtype == ttd and b.dtype == F64
            assert a.nbytes * (8 // a.element_size()) == b.nbytes
        assert set(nt.eq_rows) == (set(names) if split else set())
        for name, row in nt.eq_rows.items():
            assert row.dtype == F64
            assert torch.equal(row, getattr(f64, name)[:, :, -1])
            assert not getattr(nt, name)[:, :, -1].any()
        assert torch.equal(nt.dft_cos, nt.dft_cos.to(ttd).double())


@pytest.mark.parametrize("td", sorted(TDS))
def test_flagship_takes_narrow_tables(td):
    """``flagship.build`` (bench.py's options; analytic proposal seeds at
    lmax 16) and ``flagship_sht`` on both grids take a narrow table dtype
    under float64 compute: the full and cut transforms hold their tables
    in it and compute in float64."""
    from gibbssampler_tpu_torch import flagship
    ttd = TDS[td][0]
    scheme, _ = flagship.build("gl", "band", device="cpu", lmax=16,
                               dtype=F64, table_dtype=td, seed=True)
    m = scheme.model
    for tr in (m.sht, m.cut_sht,
               flagship.flagship_sht("healpix", 16, "cpu", F64, td)):
        assert tr.dtype == F64 and tr.table_dtype == ttd
        assert tr.lam_p2.dtype == ttd


# ---------------------------------------------------------------------------
# the band cut model: the table engine's W tables and cg_cr
# ---------------------------------------------------------------------------

LMAX_CUT = 16
NCH = 3


@pytest.fixture(scope="module")
def band():
    """{td: (JAX cut model, port cut model, fields)}, built on first use:
    a spin-2 band-masked GL dataset at lmax 16 in float64 with narrow
    tables."""
    cache = {}

    def get(td):
        if td not in cache:
            cache[td] = _band_models(td)
        return cache[td]
    return get


def _band_models(td):
    from gibbssampler_tpu.inference import example_dl
    from gibbssampler_tpu.inference import simulate_dataset as jax_simulate
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu_torch.interop import model_from_numpy
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    ttd, jtd = TDS[td]
    grid = jax_gl(LMAX_CUT)
    keep = (np.abs(np.pi / 2 - grid.theta) > 0.3).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    fields = np.stack([example_dl(LMAX_CUT, "ee", amp=10.0),
                       example_dl(LMAX_CUT, "bb", amp=10.0)])
    sht = JaxSHT(grid, LMAX_CUT, dtype=jnp.float64, spin2=True,
                 table_dtype=jtd)
    model, _ = jax_simulate(jax.random.PRNGKey(0), LMAX_CUT, spin=2,
                            dl_fields=fields, noise_sigma2=0.5,
                            fwhm_radians=0.05, mask=mask, dtype=jnp.float64,
                            sht=sht)
    mc = jax_cut(model)
    # the carried dtype as a numpy (ml_dtypes) dtype
    arrays = dict(jax_model_arrays(model), table_dtype=np.dtype(jtd))
    tc = with_cut_decomposition(model_from_numpy(arrays, device="cpu"))
    assert mc.cut_sht.table_dtype == jtd
    assert tc.cut_sht.table_dtype == tc.sht.table_dtype == ttd
    assert tc.cut_sht.lam_p2.dtype == ttd and tc.cut_sht.dtype == F64
    return mc, tc, fields


@pytest.mark.parametrize("td", sorted(TDS))
def test_table_engine_w_tables_match_jax(band, td):
    """``_prepare_tchunks`` on the narrow cut tables under float64 compute:
    the tables keep their table-dtype values, and W is formed from the
    product of the table and the rounded weights, rounded to the table
    dtype as the compiled JAX package rounds it, against the JAX
    package's (with and without the Nyquist split of the m = lmax
    column)."""
    from gibbssampler_tpu.samplers import cls_samplers as jcs
    from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
    mc, tc, _ = band(td)
    w1 = tc.w_cut[0, :, 0]
    chunks = [(1, np.array([4, 7, 8, 12, LMAX_CUT]), None, None, None)]
    for nyq in (False, True):
        mine = tcs._prepare_tchunks(tc, tc.cut_sht, chunks, w1, F64,
                                    nyq=nyq)
        ref = _jit(lambda w: [c[1:] for c in jcs._prepare_tchunks(
            mc, mc.cut_sht, chunks, w, jnp.float64, nyq=nyq)], n(w1))
        for (kind, lamA, lamB, W, _om, lnyq), rk in zip(mine, ref):
            assert kind == "s2"
            rk = (kind,) + tuple(rk)
            pairs = [(lamA, rk[1]), (lamB, rk[2]), (W, rk[3])]
            if nyq:
                pairs += [(lnyq[0], rk[5][0]), (lnyq[1], rk[5][1])]
            for k, (a, r) in enumerate(pairs):
                assert a.dtype == F64
                _close(a, np.asarray(r, np.float64), f"nyq={nyq} [{k}]")


@pytest.mark.parametrize("td", sorted(TDS))
def test_cg_cr_fixed_iterations_match_jax(band, td):
    """``cg_cr`` of 3 chains, each with its own prior, for exactly 20
    iterations (tol 0: no tolerance stop) on the band cut model with
    narrow tables, against JAX's vmapped ``cg_cr`` on the same noise pools,
    to 1e-9 of max|ref|; both count 20 iterations a chain."""
    from gibbssampler_tpu.harmonics import variance_expansion_state as jvar
    from gibbssampler_tpu.samplers import cr as jcr
    from gibbssampler_tpu_torch.samplers import cr as tcr
    mc, tc, fields = band(td)
    rng = np.random.default_rng(7)
    var = np.stack([np.asarray(jvar(jnp.asarray(f), LMAX_CUT))
                    for f in fields])
    var = var[None] * np.exp(0.5 * rng.normal(size=(NCH, 1, 1)))
    pool = {"state": rng.normal(size=(NCH, 1, mc.nfields, mc.nstate)),
            "pix": rng.normal(size=(NCH, 1) + tuple(mc.noise.tau.shape))}
    keys = jax.random.split(jax.random.PRNGKey(5), NCH)
    bt = mc.bt_ninv_d()
    ref = jax.jit(jax.vmap(lambda k, v, p: jcr.cg_cr(
        k, mc, v, bt, tol=0.0, maxiter=20, noise=p)))(
            keys, jnp.asarray(var),
            {k: jnp.asarray(v) for k, v in pool.items()})
    mine = tcr.cg_cr(tc, _t(var), tc.bt_ninv_d(), tol=0.0, maxiter=20,
                     noise={k: _t(v) for k, v in pool.items()})
    assert (n(mine[1].extra) == 20).all()
    np.testing.assert_array_equal(n(mine[1].extra), np.asarray(ref[1].extra))
    _close(mine[0], ref[0], "cg_cr state", tol=1e-9)


def test_bf16_cg_stall_is_the_jax_packages_too():
    """The bfloat16-table operator rounds its batch before each product, so
    it is not linear.  On a signal-dominated band dataset (the flagship's
    sky, noise 0.2^2 and 0.5 deg beam, at lmax 16, float64 compute) 60
    iterations of JAX's own ``cg_cr`` (which the port's matches,
    ``test_cg_cr_fixed_iterations_match_jax``) leave every chain's true
    ||b - Qx|| / ||b||, recomputed with JAX's ``q_apply_cut``, above 1e-4
    with bfloat16 tables, and below 1e-6 with float32 tables: the stall is
    the mode's, shared by both packages."""
    from gibbssampler_tpu.harmonics import variance_expansion_state as jvar
    from gibbssampler_tpu.inference import example_dl
    from gibbssampler_tpu.inference import simulate_dataset as jax_simulate
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu.samplers import cr as jcr
    grid = jax_gl(LMAX_CUT)
    keep = (np.abs(np.pi / 2 - grid.theta) > 0.2).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    fields = np.stack([example_dl(LMAX_CUT, "ee"), example_dl(LMAX_CUT, "bb")])
    floors = {}
    for td in sorted(TDS):
        sht = JaxSHT(grid, LMAX_CUT, dtype=jnp.float64, spin2=True,
                     table_dtype=TDS[td][1])
        model, _ = jax_simulate(jax.random.PRNGKey(0), LMAX_CUT, spin=2,
                                dl_fields=fields, noise_sigma2=0.2 ** 2,
                                fwhm_radians=np.radians(0.5), mask=mask,
                                dtype=jnp.float64, sht=sht)
        mc = jax_cut(model)
        rng = np.random.default_rng(8)
        var = np.stack([np.asarray(jvar(jnp.asarray(f), LMAX_CUT))
                        for f in fields])
        var = var[None] * np.exp(0.5 * rng.normal(size=(NCH, 1, 1)))
        inv = np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)
        pool = {k: jnp.asarray(v) for k, v in {
            "state": rng.normal(size=(NCH, 1, mc.nfields, mc.nstate)),
            "pix": rng.normal(size=(NCH, 1) + tuple(mc.noise.tau.shape))
        }.items()}
        keys = jax.random.split(jax.random.PRNGKey(6), NCH)
        bt = mc.bt_ninv_d()

        def resid(k, v, iv, p):
            b = jcr.fluctuated_rhs(k, mc, v, bt, noise=p)
            x, _ = jcr.cg_cr(k, mc, v, bt, tol=0.0, maxiter=60, noise=p)
            r = b - mc.q_apply_cut(x, iv)
            return jnp.linalg.norm(r) / jnp.linalg.norm(b)

        floors[td] = np.asarray(jax.jit(jax.vmap(resid))(
            keys, jnp.asarray(var), jnp.asarray(inv), pool))
    assert (floors["bfloat16"] > 1e-4).all(), floors
    assert (floors["float32"] < 1e-6).all(), floors
