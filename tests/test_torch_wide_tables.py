"""float64 Legendre tables under float32 compute in the port against the
JAX package's (CPU, x64 on, one torch thread): the four Legendre
contractions' plain versions, the GL, HEALPix and point-set transforms
with every rounding point of their azimuthal stages, the ell-selected
synthesis, the table engine's W tables, the tables
``interop.model_from_numpy`` builds, three ASIS steps with injected noise
and a fixed number of ``cg_cr`` iterations on the band cut model.

The JAX package's semantics with x64 on (bench.py runs without it, where
``jnp.dtype("float64")`` tables silently become float32; these tests pin
the x64 ones): the table and the trig matrices stay float64, the float32
batch is widened exactly, products and sums run in float64, and each
einsum or matmul output is rounded once to float32; the split synthesis
rounds its sums over even and odd l - m to float32 each and combines them
in float32, and the split adjoint forms its fold in float32.

Tolerance: ``WIDE_TOL`` = 4 float32 ulps (4 x 2^-23) of max|ref|.  Both
packages round the same float64 sums once; the sums run in other orders,
which moves a rounding only where a float64 sum lies within its last bits
of a float32 rounding boundary, and XLA, compiled, may keep an
intermediate in float64 where the source rounds it (its default excess
precision), which moves an output by a float32 ulp.  A variant that
rounds the table to float32, or sums in float32, misses the tolerance
where the products cancel: ``test_tolerance_discriminates`` builds
batches whose products cancel (components in the null space of each
table row block) and shows both variants miss it by more than 10x, at
the contractions and at the transform's own Legendre stage."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import table_pairs as tp
from gibbssampler_tpu.sht import SHT as JaxSHT
from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl
from gibbssampler_tpu.sht.healpix import make_healpix_sht as jax_healpix
from gibbssampler_tpu_torch.sht import (SHT, gauss_legendre_grid,
                                        make_healpix_sht, make_sht)
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

F64, F32 = torch.float64, torch.float32
WIDE_TOL = 4 * 2.0 ** -23
PAIR = tp.Pair(F64, F32, WIDE_TOL)


@pytest.fixture(scope="module", autouse=True)
def _x64_on():
    """The JAX package's float64 tables (x64 on)."""
    jax.config.update("jax_enable_x64", True)
    yield


# ---------------------------------------------------------------------------
# the four contractions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,nr,C,slab", [(17, 13, 5, False),
                                          (33, 19, 24, False),
                                          (33, 19, 24, True)])
def test_dense_plain_versions_match_jax(L, nr, C, slab):
    """legendre_{synth,adj}_tri on a float64 table and a float32 batch
    (their plain versions, the CPU path of the wrappers) against JAX's
    einsum of float64 operands with a float32 result; full table and a
    slab of every third row."""
    tp.dense_vs_jax(PAIR, L, nr, C, slab)


@pytest.mark.parametrize("L,nr,C,flip,slab", [
    (17, 13, 5, False, False), (33, 19, 24, True, False),
    (33, 18, 24, False, True), (33, 19, 24, True, True)])
def test_parity_plain_versions_match_jax(L, nr, C, flip, slab):
    """legendre_{synth,adj}_par on a float64 half table and a float32
    batch against the JAX package's split contractions: E and O rounded to
    float32 each, then combined in float32; the adjoint's fold formed in
    float32 and widened."""
    tp.parity_vs_jax(PAIR, L, nr, C, flip, slab)


def test_wrappers_take_the_float64_float32_pair():
    """A float64 table with a float32 batch is taken and returns float32;
    a float64 table with a 16-bit batch is refused (TypeError)."""
    lam, x, g = tp.contraction_inputs(PAIR, 7, 5, 3, 0)
    lt = torch.as_tensor(lam)
    assert lk.legendre_synth_tri(lt, torch.as_tensor(x)).dtype == F32
    assert lk.legendre_adj_par(lt[:, :, :3].contiguous(),
                               torch.as_tensor(g)).dtype == F32
    for bad in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            lk.legendre_synth_tri(lt, torch.as_tensor(x).to(bad))


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lmax,split,mode", [
    (16, False, "matmul"), (16, True, "matmul"), (31, False, "ct"),
    (31, True, "ct")])
def test_sht_matches_jax(lmax, split, mode):
    """GL ``SHT`` spin 0 and 2, synthesis, adjoint and analysis, with
    float64 tables under float32 compute: dense and split (odd ring count:
    the equator row in float32, as in the JAX package), "matmul" and "ct"
    (lmax 31: nphi 64 admits the factorization); each stage too."""
    grid = jax_gl(lmax)
    js = JaxSHT(grid, lmax, dtype=jnp.float32, spin2=True, fft_mode=mode,
                table_dtype=jnp.float64, ring_split=split)
    ts = SHT(gauss_legendre_grid(lmax), lmax, dtype=F32, spin2=True,
             device="cpu", fft_mode=mode, table_dtype="float64",
             ring_split=split)
    assert ts.fft_mode == js.fft_mode == mode and ts.ring_split == split
    assert ts.table_dtype == F64 and ts.wide
    what = f"GL {lmax} {mode} split={split}"
    tp.compare_transforms(PAIR, js, ts, (grid.nrings, grid.nphi), what)
    tp.compare_gl_stages(PAIR, js, ts, what)


@pytest.mark.parametrize("layout,split", [("ring", False), ("padded", False),
                                          ("padded", True)])
def test_healpix_matches_jax(layout, split):
    """``HealpixSHT`` at nside 8, lmax 16, with float64 tables and trig
    matrices under float32 compute, in the "ring" and "padded" layouts,
    dense and split."""
    js = jax_healpix(8, 16, dtype=jnp.float32, spin2=True, layout=layout,
                     table_dtype=jnp.float64, ring_split=split)
    ts = make_healpix_sht(8, 16, dtype=F32, spin2=True, layout=layout,
                          device="cpu", table_dtype=np.float64,
                          ring_split=split)
    tp.compare_transforms(PAIR, js, ts, (ts.npix_layout,),
                          f"HEALPix {layout}")


def test_points_match_jax():
    """``PointSHT`` values and adjoints, spin 0 and 2, and the flat-slot
    per-bin values with and without a segment matrix, with float64 tables
    under float32 compute: the slot tables stay float64, the real and
    imaginary parts' float64 sums are rounded apart."""
    tp.compare_points(PAIR)


def test_lsel_matches_jax():
    """``_lsel_F`` through ``ring_cs_lsel_spin0`` / ``ring_cs_lsel_spin2``
    with float64 tables under float32 compute, with and without ``seg``:
    the grid widened, the product and the segment sums in float64, each
    output rounded once."""
    tp.compare_lsel(PAIR)


# ---------------------------------------------------------------------------
# the tolerance, and the tables
# ---------------------------------------------------------------------------

def _cancelling(lam, b, k, synth):
    """``b`` (float64) plus k times, in each row m, random combinations of
    the null space of the row's table block: lam[m].T (nr, L) for the
    synthesis' x[m, c, :], lam[m] (L, nr) for the adjoint's g[m, :, c], so
    that the contraction of the added part is zero and its products
    cancel; rounded to float32."""
    rng = np.random.default_rng(3)
    out = b.astype(np.float64).copy()
    ncols = out.shape[1] if synth else out.shape[2]
    for m in range(lam.shape[0]):
        _, s, vt = np.linalg.svd(lam[m].T if synth else lam[m])
        null = vt[int(np.sum(s > 1e-12 * s.max())):]       # (d, L or nr)
        comb = null.T @ rng.normal(size=(null.shape[0], ncols))
        out[m] += k * (comb.T if synth else comb)
    return out.astype(np.float32)


def test_tolerance_discriminates():
    """Batches whose products cancel (``_cancelling``, k = 1e3): the port
    matches JAX within WIDE_TOL, and the contraction with the table
    rounded to float32 (float64 sums), or with float32 sums, misses it by
    more than 10x, at the dense contractions (L 17, nr 13: the synthesis'
    null space; nr 33: the adjoint's) and at the Legendre adjoint stage of
    a GL transform (its own float64 table, nr = L: a null space in every
    row m > 0)."""
    lam_s = tp.tri_table(17, 13, 30)
    lam_a = tp.tri_table(17, 33, 31)
    rng = np.random.default_rng(8)
    x = _cancelling(lam_s, rng.normal(size=(17, 5, 17)), 1e3, True)
    g = _cancelling(lam_a, rng.normal(size=(17, 33, 5)), 1e3, False)
    lmax = 16
    js = JaxSHT(jax_gl(lmax), lmax, dtype=jnp.float32,
                table_dtype=jnp.float64)
    ts = make_sht(lmax, dtype=F32, device="cpu", table_dtype="float64")
    G = _cancelling(ts.lam0.numpy(),
                    rng.normal(size=(lmax + 1, ts.nrings, 2)), 1e3, False)
    Gs = np.ascontiguousarray(G.transpose(2, 1, 0))          # (c, r, m)
    jt = tp.jax_tri(PAIR)
    refs = (jt(jnp.asarray(lam_s), x, np.zeros((17, 13, 5), np.float32))[0],
            jt(jnp.asarray(lam_a), np.zeros((17, 5, 17), np.float32), g)[1],
            tp.jit(lambda g: js._ladj_stack(js.lam0, g), Gs))

    def mine():
        return (lk.legendre_synth_tri(torch.as_tensor(lam_s),
                                      torch.as_tensor(x)),
                lk.legendre_adj_tri(torch.as_tensor(lam_a),
                                    torch.as_tensor(g)),
                ts._ladj_stack(ts.lam0, torch.as_tensor(Gs)))

    for k, (a, r) in enumerate(zip(mine(), refs)):
        PAIR.close(a, r, f"port [{k}]", stage=True)
    variants = {  # (lam, b) -> the two operands and the dtype of the sums
        "table rounded to float32": lambda lam, b: (lam.float().double(),
                                                    b.double()),
        "float32 sums": lambda lam, b: (lam.float(), b)}
    orig = (lk.legendre_synth_tri_plain, lk.legendre_adj_tri_plain)
    for what, ops in variants.items():
        lk.legendre_synth_tri_plain = (
            lambda lam, b, ms=None, ops=ops: torch.einsum(
                "mlr,mcl->mrc", *ops(lam, b)).float())
        lk.legendre_adj_tri_plain = (
            lambda lam, b, ms=None, ops=ops: torch.einsum(
                "mlr,mrc->mcl", *ops(lam, b)).float())
        try:
            errs = [tp.rel_err(a, r).max() for a, r in zip(mine(), refs)]
        finally:
            lk.legendre_synth_tri_plain, lk.legendre_adj_tri_plain = orig
        assert min(errs) > 10 * WIDE_TOL, (what, errs)


def test_tables_are_float64():
    """``make_sht(..., dtype=float32, table_dtype=float64)`` stores every
    table in float64, the split's equator rows apart in float32; the DFT
    matrices are float64."""
    tp.tables_hold_the_table_dtype(PAIR)
    ts = make_sht(31, dtype=F32, device="cpu", table_dtype="float64",
                  fft_mode="ct")
    assert ts.dft_cos.dtype == ts._ct.W1c.dtype == F64


def test_model_from_numpy_builds_jax_tables():
    """``interop.model_from_numpy`` with ``"table_dtype": "float64"`` under
    a float32 model builds the JAX model's float64 tables to 1e-14 of
    their max (the spin-2 tables come from the port's own float64
    recurrence, whose last bits differ from the JAX package's: 4.8e-15 at
    lmax 16) and its DFT matrices bit for bit."""
    tp.model_tables_equal_jax(PAIR, tol=1e-14)


def test_flagship_takes_float64_tables():
    """``flagship.build`` (float32 compute, ``table_dtype="float64"``;
    analytic proposal seeds at lmax 16) and ``flagship_sht`` on both grids
    take float64 tables under float32 compute."""
    from gibbssampler_tpu_torch import flagship
    scheme, _ = flagship.build("gl", "band", device="cpu", lmax=16,
                               dtype=F32, table_dtype="float64", seed=True)
    m = scheme.model
    for tr in (m.sht, m.cut_sht,
               flagship.flagship_sht("healpix", 16, "cpu", F32, "float64")):
        assert tr.dtype == F32 and tr.table_dtype == F64 and tr.wide
        assert tr.lam_p2.dtype == F64


def test_m_sharded_transforms_take_the_new_pairs(tmp_path):
    """``shard_sht`` of the GL transform, dense and ring-split, with float16
    tables (float32 and float64 compute) and float64 tables (float32
    compute), over two gloo processes: each holds its slab of the tables
    in the table dtype, and its spin-2 synthesis and adjoint (the kernels'
    slab form, the rows all-gathered) equal the unsharded transform's on
    both processes, bit for bit: the slab plain versions form the same
    products and sums row by row."""
    import torch_parallel_workers as tpw
    from gibbssampler_tpu.harmonics import ell_mask_state, nstate
    lmax = 9
    rng = np.random.default_rng(12)
    ns = nstate(lmax)
    grid = jax_gl(lmax)
    inputs = (*(rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2)
                for _ in range(2)),
              *(rng.normal(size=(2, grid.nrings, grid.nphi))
                for _ in range(2)))
    pairs = (("float16", "float32"), ("float16", "float64"),
             ("float64", "float32"))
    res = tpw.spawn(tpw.table_pair_transforms, 2, tmp_path, lmax, pairs,
                    inputs)
    for out in res:
        for td, cd in pairs:
            for split in (0, 1):
                key = f"{td}_{cd}_{split}"
                assert out[f"{key}_dtype"].all()
                for k in "queb":
                    np.testing.assert_array_equal(
                        out[f"{key}_sharded_{k}"], out[f"{key}_full_{k}"],
                        err_msg=f"{key} {k}")


# ---------------------------------------------------------------------------
# the band cut model: the W tables, ASIS steps and cg_cr
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def band():
    return tp.band_models(PAIR)


def test_table_engine_w_tables_match_jax(band):
    """``_prepare_tchunks`` on the float64 cut tables under float32: W is
    the float64 einsum of the float64 product of the table and the widened
    weights and the table, rounded once to float32, and the tables the
    sweep contracts are the float64 tables rounded once to float32,
    against the JAX package's W and float64 tables (with and without the
    Nyquist split)."""
    tp.w_tables_vs_jax(PAIR, *band[:2])


@pytest.mark.filterwarnings("ignore:Explicitly requested dtype float64")
def test_asis_steps_match_jax(band):
    """Three ASIS iterations of 4 chains on the band cut model with float64
    tables under float32 compute (table engine), JAX with x64 on: the CR
    and MH accepts equal, the state and D_ell within 2e-4 of max|ref|
    (``table_pairs.asis_steps_vs_jax``)."""
    tp.asis_steps_vs_jax(PAIR, *band, n_steps=3)


def test_cg_cr_fixed_iterations_match_jax(band):
    """``cg_cr`` of 3 chains for exactly 10 iterations on the band cut
    model with float64 tables under float32 compute, against JAX's, to
    1e-4 of max|ref|: float32 iterations compound the float32 roundings of
    two programs whose sums run in other orders."""
    tp.cg_cr_vs_jax(PAIR, *band, tol=1e-4, iters=10)
