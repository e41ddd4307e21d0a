"""The bfloat16 table mode of the port against the JAX package's (float32
compute, bfloat16 tables, CPU, one torch thread): the four Legendre
contractions' plain versions and the Pallas kernels, the GL, HEALPix and
point-set transforms with every bfloat16 rounding point of their azimuthal
stages, the ell-selected synthesis, the table engine's W tables, and one
ASIS step of the band cut model.

Each JAX call runs under ``jax.jit``, with the transform closed over (its
tables become constants of the compiled program): the CPU runtime of the
JAX this was written against has no bfloat16 x bfloat16 -> float32 dot
("Unsupported element type for DotThunk::Execute"), which eager calls and
batched products on bfloat16 arguments reach (``HealpixSHT``'s synthesis,
``PointSHT``, the Pallas adjoint); compiled on constant tables they run.
The JAX side runs with ``jax_enable_x64`` off.

The comparisons are at 1e-5 of max|ref|, float32 accumulation noise: the
port forms the same exact bfloat16 products as the JAX package and sums
them in float32.  A contraction that rounds its result, or its operands, at
another place misses that by the size of the bfloat16 operator error (some
1e-3), and ``test_tolerance_discriminates`` shows it does."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import n, tri_table
from gibbssampler_tpu.harmonics import ell_mask_state, nstate
from gibbssampler_tpu.sht import SHT as JaxSHT
from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl
from gibbssampler_tpu.sht.healpix import make_healpix_sht as jax_healpix
from gibbssampler_tpu.sht.pallas_legendre import (
    legendre_adj_tri as pallas_adj, legendre_synth_tri as pallas_synth)
from gibbssampler_tpu.sht.points import PointSHT as JaxPointSHT
from gibbssampler_tpu_torch.sht import (SHT, PointSHT, gauss_legendre_grid,
                                        make_healpix_sht, make_sht)
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

BF = jnp.bfloat16
F32 = jnp.float32
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _x64_off():
    """The JAX package's bfloat16 path as it runs in float32 programs."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _err(mine, ref) -> float:
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(n(mine).astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def _close(mine, ref, what, tol=TOL):
    err = _err(mine, ref)
    assert err <= tol, f"{what}: {err:.3g} max|ref| > {tol}"


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# the four contractions
# ---------------------------------------------------------------------------

def _inputs(L, nr, C, seed):
    rng = np.random.default_rng(seed)
    lam = tri_table(L, nr, seed)
    return (lam, rng.normal(size=(L, C, L)).astype(np.float32),
            rng.normal(size=(L, nr, C)).astype(np.float32))


def _parity(L, nt, ms):
    """(even, odd) masks of l - m over (M, L, 1), m = ms."""
    odd = (np.arange(L)[None, :] - np.asarray(ms)[:, None]) % 2
    return ((1 - odd)[:, :, None].astype(np.float32),
            odd[:, :, None].astype(np.float32))


@jax.jit
def _jax_tri(lam, x, g):
    """JAX's dense contractions: bfloat16 operands, float32 result."""
    return (jnp.einsum("mlr,mcl->mrc", lam, x.astype(BF),
                       preferred_element_type=F32),
            jnp.einsum("mlr,mrc->mcl", lam, g.astype(BF),
                       preferred_element_type=F32))


@jax.jit
def _jax_par(lamE, lamO, x, g, f):
    """The JAX package's split contractions (lcore ``_lsynth_stack_sym`` /
    ``_ladj_stack_sym``) with the parity masks folded into the tables:
    synthesis E + O north, f (E - O) south; the adjoint folds the south rows
    in float32, then rounds U and V."""
    nh = lamE.shape[2]
    xb = x.astype(BF)
    E = jnp.einsum("mlr,mcl->mrc", lamE, xb, preferred_element_type=F32)
    O = jnp.einsum("mlr,mcl->mrc", lamO, xb, preferred_element_type=F32)
    nr = g.shape[1]
    south = (f * (E - O))[:, : nr - nh][:, ::-1]
    gn = g[:, :nh]
    gs = jnp.zeros_like(gn).at[:, : nr - nh].set(g[:, nh:][:, ::-1]) * f
    U, V = (gn + gs).astype(BF), (gn - gs).astype(BF)
    return (jnp.concatenate([E + O, south], axis=1),
            jnp.einsum("mlr,mrc->mcl", lamE, U, preferred_element_type=F32)
            + jnp.einsum("mlr,mrc->mcl", lamO, V, preferred_element_type=F32))


@pytest.mark.parametrize("L,nr,C,slab", [(17, 13, 5, False),
                                          (33, 19, 24, False),
                                          (33, 19, 24, True)])
def test_dense_plain_versions_match_jax(L, nr, C, slab):
    """legendre_{synth,adj}_tri on a bfloat16 table and a float32 batch
    (their plain versions, the CPU path of the wrappers) against JAX's
    einsum of bfloat16 operands with a float32 result; full table and a
    slab of every third row."""
    lam, x, g = _inputs(L, nr, C, L + nr)
    ms = np.arange(1, L, 3) if slab else np.arange(L)
    lb = torch.as_tensor(lam[ms]).to(torch.bfloat16)
    msk = torch.as_tensor(ms, dtype=torch.int32) if slab else None
    out_s = lk.legendre_synth_tri(lb, _t(x[ms]), msk)
    out_a = lk.legendre_adj_tri(lb, _t(g[ms]), msk)
    assert out_s.dtype == out_a.dtype == torch.float32
    ref_s, ref_a = _jax_tri(jnp.asarray(lam[ms], BF), x[ms], g[ms])
    _close(out_s, ref_s, "synth")
    _close(out_a, ref_a, "adj")


@pytest.mark.parametrize("L,nr,C,flip,slab", [
    (17, 13, 5, False, False), (17, 13, 5, True, False),
    (33, 19, 24, True, False), (33, 18, 24, False, False),
    (33, 19, 24, False, True), (33, 18, 24, True, True)])
def test_parity_plain_versions_match_jax(L, nr, C, flip, slab):
    """legendre_{synth,adj}_par on a bfloat16 half table (odd nr: the
    equator row; even: none), flip and not, full and slab, against the JAX
    package's split contractions, whose adjoint rounds the float32 fold."""
    nh = (nr + 1) // 2
    lam, x, g = _inputs(L, nh, C, L + nr)
    g = np.random.default_rng(nr).normal(size=(L, nr, C)).astype(np.float32)
    ms = np.arange(2, L, 3) if slab else np.arange(L)
    lb = torch.as_tensor(lam[ms]).to(torch.bfloat16)
    msk = torch.as_tensor(ms, dtype=torch.int32) if slab else None
    out_s = lk.legendre_synth_par(lb, _t(x[ms]), nr, flip, msk)
    out_a = lk.legendre_adj_par(lb, _t(g[ms]), flip, msk)
    ev, od = _parity(L, nh, ms)
    lj = np.asarray(jnp.asarray(lam[ms], BF).astype(F32))
    ref_s, ref_a = _jax_par(jnp.asarray(lj * ev, BF), jnp.asarray(lj * od, BF),
                            x[ms], g[ms], -1.0 if flip else 1.0)
    _close(out_s, ref_s, "synth par")
    _close(out_a, ref_a, "adj par")


def test_pallas_kernels_bf16_match_plain_versions():
    """The Pallas kernels, jitted in interpret mode at tests/test_pallas.py's
    shapes on the bfloat16 table, against the port's plain versions on the
    same table and the float32 batch they round.  The synthesis takes the
    batch in bfloat16; the adjoint's bfloat16 x bfloat16 dot does not run
    on the CPU even compiled, so it takes the batch's bfloat16 values in
    float32, whose products with the table are the same."""
    L, nr, C = 16, 12, 8
    lam, x, g = _inputs(L, nr, C, 3)
    lb = jnp.asarray(lam, BF)
    synth = jax.jit(lambda a, b: pallas_synth(a, b, tile_l=4, tile_r=4,
                                              interpret=True))
    adj = jax.jit(lambda a, b: pallas_adj(a, b, tile_l=4, tile_r=4,
                                          interpret=True))
    lt = torch.as_tensor(lam).to(torch.bfloat16)
    _close(lk.legendre_synth_tri(lt, _t(x)), synth(lb, jnp.asarray(x, BF)),
           "pallas synth")
    _close(lk.legendre_adj_tri(lt, _t(g)),
           adj(lb, jnp.asarray(g, BF).astype(F32)), "pallas adj")


def test_wrappers_take_only_the_bf16_float32_pair():
    """A bfloat16 table with a narrow batch raises TypeError on the CPU as
    on the card: a bfloat16 or float16 batch (the float64 batch is the
    float64-compute mode, ``test_wrappers_take_the_bf16_float64_pair``)."""
    lam, x, g = _inputs(7, 5, 3, 0)
    lb = torch.as_tensor(lam).to(torch.bfloat16)
    for bad in (torch.bfloat16, torch.float16):
        with pytest.raises(TypeError):
            lk.legendre_synth_tri(lb, _t(x).to(bad))
        with pytest.raises(TypeError):
            lk.legendre_adj_par(lb, torch.zeros((7, 9, 3), dtype=bad))


def test_wrappers_take_the_bf16_float64_pair():
    """A bfloat16 table with a float64 batch is taken (the float64-compute
    mode of tests/test_torch_f64_tables.py): every wrapper returns float64,
    the batch rounded to bfloat16 and the products summed in float64."""
    lam, x, g = _inputs(7, 5, 3, 0)
    lb = torch.as_tensor(lam).to(torch.bfloat16)
    x64 = torch.as_tensor(x, dtype=torch.float64)
    out = lk.legendre_synth_tri(lb, x64)
    assert out.dtype == torch.float64
    ref = torch.einsum("mlr,mcl->mrc", lb.double(),
                       x64.float().to(torch.bfloat16).double())
    assert torch.equal(out, ref)
    g9 = torch.as_tensor(np.random.default_rng(1).normal(size=(7, 9, 3)))
    assert lk.legendre_adj_par(lb, g9).dtype == torch.float64


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

_METHODS = ("synthesis_state", "adjoint_synthesis_state", "analysis_state",
            "synthesis_spin2_state", "adjoint_synthesis_spin2_state",
            "analysis_spin2_state")


def _jit(fn, *args):
    """``fn(*args)`` compiled (``fn`` closes over the JAX transform)."""
    return jax.jit(fn)(*args)


def _jax_all(js, x, f, e, b, q, u):
    return _jit(lambda x, f, e, b, q, u: (
        js.synthesis_state(x), js.adjoint_synthesis_state(f),
        js.analysis_state(f), js.synthesis_spin2_state(e, b),
        js.adjoint_synthesis_spin2_state(q, u),
        js.analysis_spin2_state(q, u)), x, f, e, b, q, u)


def _inputs_for(ts, lmax, maps_shape, seed):
    rng = np.random.default_rng(seed)
    ns = nstate(lmax)
    st = lambda spin: (rng.normal(size=(2, ns))
                       * ell_mask_state(lmax, spin)).astype(np.float32)
    return (st(0), rng.normal(size=(2,) + maps_shape).astype(np.float32),
            st(2), st(2), *(rng.normal(size=(2,) + maps_shape)
                            .astype(np.float32) for _ in range(2)))


def _compare_transforms(js, ts, maps_shape, what, skip_analysis=False):
    x, f, e, b, q, u = _inputs_for(ts, ts.lmax, maps_shape, 11)
    ref = _jax_all(js, x, f, e, b, q, u)
    args = {"synthesis_state": (x,), "adjoint_synthesis_state": (f,),
            "analysis_state": (f,), "synthesis_spin2_state": (e, b),
            "adjoint_synthesis_spin2_state": (q, u),
            "analysis_spin2_state": (q, u)}
    for meth, r in zip(_METHODS, ref):
        mine = getattr(ts, meth)(*map(_t, args[meth]))
        mine = mine if isinstance(mine, tuple) else (mine,)
        r = r if isinstance(r, tuple) else (r,)
        for k, (a, rr) in enumerate(zip(mine, r)):
            assert a.dtype == torch.float32
            _close(a, rr, f"{what} {meth}[{k}]")


@pytest.mark.parametrize("lmax,split,mode", [
    (16, False, "matmul"), (16, True, "matmul"), (32, True, "matmul"),
    (47, False, "ct"), (47, True, "ct"), (16, False, "fft")])
def test_sht_matches_jax(lmax, split, mode):
    """GL ``SHT`` spin 0 and 2, synthesis, adjoint and analysis, with
    bfloat16 tables: dense and split (odd ring count: the equator row
    stays float32, as in the JAX package), "matmul", "ct" (lmax 47: nphi
    96 admits the factorization) and "fft" (which takes no table dtype)."""
    grid = jax_gl(lmax)
    js = JaxSHT(grid, lmax, dtype=F32, spin2=True, fft_mode=mode,
                table_dtype=BF, ring_split=split)
    ts = SHT(gauss_legendre_grid(lmax), lmax, dtype=torch.float32,
             spin2=True, device="cpu", fft_mode=mode,
             table_dtype="bfloat16", ring_split=split)
    assert ts.fft_mode == js.fft_mode and ts.ring_split == split
    _compare_transforms(js, ts, (grid.nrings, grid.nphi),
                        f"GL {lmax} {mode} split={split}")


@pytest.mark.parametrize("layout,split", [("ring", False), ("padded", False),
                                          ("padded", True)])
def test_healpix_matches_jax(layout, split):
    """``HealpixSHT`` at nside 8, lmax 16, with bfloat16 tables and trig
    matrices, in the "ring" and "padded" layouts, dense and split."""
    js = jax_healpix(8, 16, dtype=F32, spin2=True, layout=layout,
                     table_dtype=BF, ring_split=split)
    ts = make_healpix_sht(8, 16, dtype=torch.float32, spin2=True,
                          layout=layout, device="cpu",
                          table_dtype=torch.bfloat16, ring_split=split)
    _compare_transforms(js, ts, (ts.npix_layout,), f"HEALPix {layout}")


def _point_pair(lmax=16):
    rng = np.random.default_rng(4)
    nrows, p = 6, 5
    theta = np.sort(rng.uniform(0.2, 2.9, nrows))
    phi = rng.uniform(0, 2 * np.pi, (nrows, p))
    valid = (rng.uniform(size=(nrows, p)) < 0.8).astype(np.float64)
    valid[:, 0] = 1.0
    js = JaxPointSHT(theta, phi, valid, lmax, dtype=F32, spin2=True,
                     table_dtype=BF)
    ts = PointSHT(theta, phi, valid, lmax, dtype=torch.float32, spin2=True,
                  device="cpu", table_dtype="bfloat16")
    return js, ts


def test_points_match_jax():
    """``PointSHT`` values and adjoints, spin 0 and 2, and the flat-slot
    per-bin values ``values_flat_spin0_gsel`` / ``values_flat_spin2_gsel``
    with and without a segment matrix, with bfloat16 tables."""
    lmax = 16
    js, ts = _point_pair(lmax)
    rng = np.random.default_rng(5)
    ns = nstate(lmax)
    x, e, b = ((rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2))
               .astype(np.float32) for _ in range(3))
    f, q, u = (rng.normal(size=(2, ts.nrows, ts.p)).astype(np.float32)
               for _ in range(3))
    ref = _jit(lambda x, f, e, b, q, u: (
        js.synthesis_state(x), js.adjoint_synthesis_state(f),
        js.synthesis_spin2_state(e, b),
        js.adjoint_synthesis_spin2_state(q, u)), x, f, e, b, q, u)
    mine = (ts.synthesis_state(_t(x)), ts.adjoint_synthesis_state(_t(f)),
            ts.synthesis_spin2_state(_t(e), _t(b)),
            ts.adjoint_synthesis_spin2_state(_t(q), _t(u)))
    for k, (a, r) in enumerate(zip(mine, ref)):
        for i, (aa, rr) in enumerate(zip(*((v,) if not isinstance(v, tuple)
                                           else v for v in (a, r)))):
            _close(aa, rr, f"points [{k}][{i}]")
    j_idx = np.array([3, 5, 6, 9, 12, 16])
    seg = np.zeros((6, 3), np.float32)
    seg[[0, 1, 2, 3, 4, 5], [0, 0, 1, 1, 2, 2]] = 1.0
    gsel = rng.normal(size=(2, 2, lmax + 1, 6)).astype(np.float32)
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


def test_lsel_matches_jax():
    """``_lsel_F`` through ``ring_cs_lsel_spin0`` / ``ring_cs_lsel_spin2``
    on a GL transform with bfloat16 tables, with and without ``seg``: the
    grid rounded, the product formed in bfloat16, the segment sums in
    float32."""
    lmax = 16
    js = JaxSHT(jax_gl(lmax), lmax, dtype=F32, spin2=True, table_dtype=BF)
    ts = make_sht(lmax, dtype=torch.float32, spin2=True, device="cpu",
                  table_dtype="bfloat16")
    rng = np.random.default_rng(6)
    ns = nstate(lmax)
    x, e, b = ((rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2))
               .astype(np.float32) for _ in range(3))
    j_idx = np.array([2, 4, 5, 8, 11, 15, 16])
    seg = np.zeros((7, 3), np.float32)
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
    """The comparisons above, with the Legendre contractions computed as
    einsums of bfloat16 tensors (whose results torch rounds to bfloat16),
    miss the tolerance by far: the dense kernels' comparison, the Legendre
    stage of the spin-0 synthesis, and the whole spin-0 adjoint.  (The
    synthesis' maps would not show it: the ring DFT rounds the Legendre
    stage's output to bfloat16 next, in the JAX package and the port.)"""
    lmax = 16
    js = JaxSHT(jax_gl(lmax), lmax, dtype=F32, table_dtype=BF)
    ts = make_sht(lmax, dtype=torch.float32, device="cpu",
                  table_dtype="bfloat16")
    x, f = _inputs_for(ts, lmax, (ts.nrings, ts.nphi), 3)[:2]
    g2 = np.asarray(_jit(lambda x: js._state_grids(x), x))
    lam, xk, gk = _inputs(17, 13, 5, 30)
    refs = (_jax_tri(jnp.asarray(lam, BF), xk, gk)
            + (_jit(lambda g: js._lsynth_stack(js.lam0, g), g2),
               _jit(lambda f: js.adjoint_synthesis_state(f), f)))
    lt = torch.as_tensor(lam).to(torch.bfloat16)

    def mine():
        return (lk.legendre_synth_tri(lt, _t(xk)),
                lk.legendre_adj_tri(lt, _t(gk)),
                ts._lsynth_stack(ts.lam0, _t(g2)),
                ts.adjoint_synthesis_state(_t(f)))

    for a, r in zip(mine(), refs):
        _close(a, r, "port")
    bf16_out = {
        "legendre_synth_tri_plain": lambda lam, b, ms=None: torch.einsum(
            "mlr,mcl->mrc", lam, b.to(torch.bfloat16)).float(),
        "legendre_adj_tri_plain": lambda lam, b, ms=None: torch.einsum(
            "mlr,mrc->mcl", lam, b.to(torch.bfloat16)).float()}
    orig = {k: getattr(lk, k) for k in bf16_out}
    try:
        for k, fn in bf16_out.items():
            setattr(lk, k, fn)
        errs = [_err(a, r) for a, r in zip(mine(), refs)]
    finally:
        for k, fn in orig.items():
            setattr(lk, k, fn)
    assert min(errs) > 30 * TOL, errs


def test_tables_are_bf16_at_half_the_bytes():
    """``make_sht(..., table_dtype="bfloat16")`` stores lam0, lam_p2 /
    lam_m2 (dense) and lam_w / lam_x (split) in bfloat16, each at half the
    bytes of the float32 transform's, the split's float32 equator rows
    apart; the DFT matrices hold bfloat16 values in float32."""
    for split in (False, True):
        kw = dict(dtype=torch.float32, spin2=True, device="cpu",
                  ring_split=split)
        hb = make_sht(16, table_dtype="bfloat16", **kw)
        f32 = make_sht(16, **kw)
        names = ("lam0", "lam_w", "lam_x") if split else ("lam0", "lam_p2",
                                                           "lam_m2")
        for name in names:
            a, b = getattr(hb, name), getattr(f32, name)
            assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
            assert a.nbytes * 2 == b.nbytes
        assert set(hb.eq_rows) == (set(names) if split else set())
        for name, row in hb.eq_rows.items():
            assert row.dtype == torch.float32
            assert torch.equal(row, getattr(f32, name)[:, :, -1])
            assert not getattr(hb, name)[:, :, -1].any()
        assert torch.equal(hb.dft_cos, hb.dft_cos.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# the band cut model: the table engine's W tables and one ASIS step
# ---------------------------------------------------------------------------

LMAX_CUT = 16
NCH = 4
BINS = [np.arange(2, LMAX_CUT + 2),
        np.array([2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 17])]
BLOCKS = [[(0, LMAX_CUT - 1)], [(0, 3)] + [(i, i + 1) for i in range(3, 10)]]


@pytest.fixture(scope="module")
def band():
    return _band_models()


def _band_models():
    """A spin-2 band-masked GL dataset at lmax 16 in float32 with bfloat16
    tables, in the JAX package (its cut decomposition) and in the port."""
    from gibbssampler_tpu.inference import example_dl
    from gibbssampler_tpu.inference import simulate_dataset as jax_simulate
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu_torch.interop import model_from_numpy
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    from torch_parity import jax_model_arrays
    grid = jax_gl(LMAX_CUT)
    keep = (np.abs(np.pi / 2 - grid.theta) > 0.3).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    fields = np.stack([example_dl(LMAX_CUT, "ee", amp=10.0),
                       example_dl(LMAX_CUT, "bb", amp=10.0)])
    sht = JaxSHT(grid, LMAX_CUT, dtype=F32, spin2=True, table_dtype=BF)
    model, _ = jax_simulate(jax.random.PRNGKey(0), LMAX_CUT, spin=2,
                            dl_fields=fields, noise_sigma2=0.5,
                            fwhm_radians=0.05, mask=mask, dtype=F32,
                            sht=sht)
    mc = jax_cut(model)
    arrays = dict(jax_model_arrays(model), table_dtype="bfloat16")
    tc = with_cut_decomposition(model_from_numpy(arrays, device="cpu",
                                                 dtype=torch.float32))
    assert mc.cut_sht.table_dtype == BF
    assert tc.cut_sht.table_dtype == tc.sht.table_dtype == torch.bfloat16
    assert tc.cut_sht.lam_p2.dtype == torch.bfloat16
    return mc, tc, fields


def test_table_engine_w_tables_match_jax(band):
    """``_prepare_tchunks`` on the bfloat16 cut tables: the tables keep
    their bfloat16 values, and W is formed from the bfloat16 product of the
    table and the rounded weights, against the JAX package's (with and
    without the Nyquist split of the m = lmax column)."""
    from gibbssampler_tpu.samplers import cls_samplers as jcs
    from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
    mc, tc, _ = band
    w1 = tc.w_cut[0, :, 0]
    chunks = [(1, np.array([4, 7, 8, 12, LMAX_CUT]), None, None, None)]
    for nyq in (False, True):
        mine = tcs._prepare_tchunks(tc, tc.cut_sht, chunks, w1,
                                    torch.float32, nyq=nyq)
        ref = _jit(lambda w: [c[1:] for c in jcs._prepare_tchunks(
            mc, mc.cut_sht, chunks, w, F32, nyq=nyq)], n(w1))
        for (kind, lamA, lamB, W, _om, lnyq), rk in zip(mine, ref):
            assert kind == "s2"
            rk = (kind,) + tuple(rk)
            pairs = [(lamA, rk[1]), (lamB, rk[2]), (W, rk[3])]
            if nyq:
                pairs += [(lnyq[0], rk[5][0]), (lnyq[1], rk[5][1])]
            for k, (a, r) in enumerate(pairs):
                _close(a, np.asarray(r, np.float32), f"nyq={nyq} [{k}]")


# jax_mh_uniforms asks for float64 uniforms; with x64 off JAX draws them in
# float32, as the float32 JAX step does
@pytest.mark.filterwarnings("ignore:Explicitly requested dtype float64")
def test_asis_step_matches_jax(band):
    """One ASIS iteration of 4 chains on the band cut model with bfloat16
    tables (table engine), the JAX scheme's jitted vmapped step against the
    port's on the same pools, MALA uniform, gamma variates and MH uniforms:
    the CR and MH accepts are equal, and the state and D_ell agree to 2e-4
    of max|ref| (float32 programs whose sums run in other orders, through
    an MH sweep that feeds each block's accepted state to the next).  The
    accepts are compared exactly: neither step exposes its log-ratio, so
    a flip fails the test naming the chains and blocks that flipped and
    the log-uniform that the two log-ratios straddle there (no seed is
    changed to hide one)."""
    from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
    from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
    from gibbssampler_tpu.schemes import GibbsState as JaxState
    from gibbssampler_tpu_torch.interop import state_from_numpy
    from gibbssampler_tpu_torch.schemes import ASISGibbs
    from torch_parity import jax_mh_uniforms
    mc, tc, fields = band
    dl0 = [np.array([f[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])])
           for f, b in zip(fields, BINS)]
    sig = [0.3 * d for d in dl0]
    kw = dict(n_iter_mh=1, cr_method="aux_mala",
              cr_options={"n_gibbs": 1, "tau": 0.02})
    jsch = JaxASIS(mc, BINS, BLOCKS, sig, **kw)
    tsch = ASISGibbs(tc, BINS, BLOCKS, sig, **kw)
    assert tsch.mh_plan.engine == "table"
    dls = tuple(np.tile(d, (NCH, 1)).astype(np.float32) for d in dl0)
    var = np.asarray(_jit(jax.vmap(jsch.var_cls),
                          tuple(jnp.asarray(d) for d in dls)))
    s0 = (np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
          ).astype(np.float32)
    rng = np.random.default_rng(1)
    pool = {"state": rng.normal(size=(NCH, 2, 2, tc.nstate)),
            "aux": rng.normal(size=(NCH, 1) + tuple(tc.w_cut.shape))}
    pool = {k: v.astype(np.float32) for k, v in pool.items()}
    keys = jax.random.split(jax.random.PRNGKey(100), NCH)
    jstate, jinfo = _jit(jax.vmap(jsch.step), keys,
                         JaxState(s=jnp.asarray(s0),
                                  dl=tuple(jnp.asarray(d) for d in dls)),
                         {k: jnp.asarray(v) for k, v in pool.items()})
    ell = jnp.arange(LMAX_CUT + 1, dtype=F32)
    alphas = []
    for b in BINS:
        a = jax_bin_sum(2.0 * ell + 1.0, b, LMAX_CUT) / 2.0 - 1.0
        alphas.append(jnp.where(a <= 0, 1.0, a))
    ntot = sum(len(b) - 1 for b in BINS)
    nblocks = sum(map(len, BLOCKS))
    u, gam, up, ua = [], [[], []], [], []
    for key in keys:
        k1, k2, k3 = jax.random.split(key, 3)
        ka = jax.random.split(jax.random.split(k1)[1])[1]
        u.append(float(jax.random.uniform(ka, dtype=F32)))
        for f, kf in enumerate(jax.random.split(k2, 2)):
            gam[f].append(np.asarray(jax.random.gamma(kf, alphas[f])))
        p_, a_ = jax_mh_uniforms(k3, 1, ntot, nblocks)
        up.append(p_)
        ua.append(a_)
    tstate = state_from_numpy(s0, dls, device="cpu", dtype=torch.float32)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tstate, tinfo = tsch.step(
        tstate, noise={k: t32(v) for k, v in pool.items()}, u=t32(u),
        gammas=tuple(t32(g) for g in gam), u_prop=t32(up), u_acc=t32(ua))
    log_ua = np.log(np.asarray(ua))[:, 0]                 # (chains, blocks)
    offs = np.cumsum([0] + [len(b) for b in BLOCKS])
    for what, mine, ref, log_u in (
            [("CR", tinfo["cr_accept"], jinfo["cr_accept"], np.log(u))]
            + [(f"MH field {f}", tinfo["mh_accept"][f], jinfo["mh_accept"][f],
                log_ua[:, offs[f]: offs[f + 1]]) for f in range(2)]):
        mine, ref = n(mine).reshape(np.shape(log_u)), np.asarray(ref).reshape(
            np.shape(log_u))
        bad = np.argwhere(mine != ref)
        assert bad.size == 0, (
            f"{what} accept flipped at (chain, block) {bad.tolist()}: the "
            f"port's and JAX's log-ratios straddle log u = "
            f"{[float(log_u[tuple(i)]) for i in bad]}")
    for what, mine, ref in [("s", tstate.s, jstate.s),
                            ("dl[0]", tstate.dl[0], jstate.dl[0]),
                            ("dl[1]", tstate.dl[1], jstate.dl[1])]:
        _close(mine, ref, what, tol=2e-4)
