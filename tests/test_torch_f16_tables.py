"""float16 Legendre tables in the port against the JAX package's, under
float32 and under float64 compute (CPU, x64 on, one torch thread): the
one-rounding float64 -> float16 conversion, the four Legendre
contractions' plain versions, the GL, HEALPix and point-set transforms
(and, under float32, each stage of the GL "matmul" ones) with every
rounding point of their azimuthal stages, the ell-selected synthesis, the
table engine's W tables, the tables ``interop.model_from_numpy`` builds,
three ASIS steps with injected noise (float32) and a fixed number of
``cg_cr`` iterations (float64) on the band cut model, and non-finite
outputs where a batch overflows float16.

Tolerances.  Under float64 compute, 1e-12 of max|ref| (float64
accumulation noise, as tests/test_torch_f64_tables.py): each data operand
is rounded to float16 before its product, the product of two float16
values is exact, and the products are summed in float64.  Under float32
compute, 1e-5 of max|ref| (float32 accumulation noise, as bfloat16 in
tests/test_torch_bf16.py) for each stage on the same input; a whole
transform may hold flips (``table_pairs.Pair.close``): the two packages
sum float32 products in other orders, and an operand whose sum lies
within its last bit of a float16 rounding boundary rounds to the other
neighbour before the next stage, so at most 2% of a transform's outputs
may miss 1e-5, by at most 2^-11 (one float16 step) of max|ref|.  A
contraction or a stage that skips a rounding, or rounds at another place,
misses by the size of float16's rounding (some 1e-4) nearly everywhere;
``test_tolerance_discriminates`` shows it does."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import table_pairs as tp
from torch_parity import n
from gibbssampler_tpu.sht import SHT as JaxSHT
from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl
from gibbssampler_tpu.sht.healpix import make_healpix_sht as jax_healpix
from gibbssampler_tpu_torch.sht import (SHT, gauss_legendre_grid,
                                        make_healpix_sht, make_sht)
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

PAIRS = {"float32": tp.Pair(torch.float16, torch.float32, 1e-5, flips=0.02,
                            flip_tol=2.0 ** -11),
         "float64": tp.Pair(torch.float16, torch.float64, 1e-12)}
# rounds to 1.0 through float32 (torch's conversion) and to 1 + 2^-10 in
# one rounding to float16 (numpy's and JAX's)
DOUBLE_ROUNDING = 1.0 + 2.0 ** -11 + 2.0 ** -40
# ties and their neighbours, subnormals, the largest float16, the first
# values that overflow it, infinities, NaN and -0
EDGES = (1.0 + 2.0 ** -11, DOUBLE_ROUNDING, 1.0 + 2.0 ** -11 - 2.0 ** -40,
         -DOUBLE_ROUNDING, 1.0 + 3 * 2.0 ** -11, 2.0 ** -24, 2.0 ** -25,
         2.0 ** -25 + 2.0 ** -60, 3 * 2.0 ** -26, 2.0 ** -14 - 2.0 ** -25,
         2.0 ** -14 - 2.0 ** -25 + 2.0 ** -50, 65504.0, 65519.99, 65520.0,
         -65520.0, 1e300, np.inf, -np.inf, np.nan, -0.0, 0.0)


@pytest.fixture(scope="module", autouse=True)
def _x64_on():
    """The JAX package's float64 programs (its float32 ones run too)."""
    jax.config.update("jax_enable_x64", True)
    yield


def test_cast_to_rounds_float64_to_float16_once():
    """``legendre_kernels.cast_to`` rounds float64 to float16 once, as
    numpy does (and JAX with x64 on), bit for bit over 10^6 values of every
    magnitude and the edge cases (ties, subnormals, 65504, 65519.99, 65520,
    +-inf, NaN, -0); torch's own conversion, through float32, misses some."""
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=10 ** 6)
                        * np.exp(rng.uniform(-30.0, 12.0, 10 ** 6)), EDGES])
    with np.errstate(over="ignore"):
        want = v.astype(np.float16)
    mine = lk.cast_to(torch.from_numpy(v), torch.float16).numpy()
    assert np.array_equal(mine.view(np.uint16), want.view(np.uint16))
    twice = torch.from_numpy(v).to(torch.float16).numpy()
    assert not np.array_equal(twice.view(np.uint16), want.view(np.uint16))
    jv = np.asarray(jax.jit(lambda a: a.astype(jnp.float16))(v[-40:]))
    assert np.array_equal(jv.view(np.uint16), want[-40:].view(np.uint16))


# ---------------------------------------------------------------------------
# the four contractions
# ---------------------------------------------------------------------------

def _double_rounding(x, g, ms=None):
    """The double-rounding value in x and g (and, with ``ms``, in a parity
    fold: north ring 0 and its mirror at row ms[0])."""
    L, C = x.shape[0], x.shape[1]
    x[L - 1, 0, L - 1] = x[L - 2, C - 1, L - 1] = DOUBLE_ROUNDING
    if ms is None:
        g[L - 1, 0, C - 1] = DOUBLE_ROUNDING
    else:
        g[ms[0], 0, 1] = DOUBLE_ROUNDING - 2.0 ** -10
        g[ms[0], g.shape[1] - 1, 1] = 2.0 ** -10


@pytest.mark.parametrize("cd", sorted(PAIRS))
@pytest.mark.parametrize("L,nr,C,slab", [(17, 13, 5, False),
                                          (33, 19, 24, False),
                                          (33, 19, 24, True)])
def test_dense_plain_versions_match_jax(cd, L, nr, C, slab):
    """legendre_{synth,adj}_tri on a float16 table (their plain versions,
    the CPU path of the wrappers) against JAX's einsum of float16 operands
    with a compute-dtype result; full table and a slab of every third
    row; the batch holds the double-rounding value."""
    tp.dense_vs_jax(PAIRS[cd], L, nr, C, slab, _double_rounding)


@pytest.mark.parametrize("cd", sorted(PAIRS))
@pytest.mark.parametrize("L,nr,C,flip,slab", [
    (17, 13, 5, False, False), (33, 19, 24, True, False),
    (33, 18, 24, False, True), (33, 19, 24, True, True)])
def test_parity_plain_versions_match_jax(cd, L, nr, C, flip, slab):
    """legendre_{synth,adj}_par on a float16 half table against the JAX
    package's split contractions (E and O in the compute dtype, the fold
    formed in it and rounded once); a fold is the double-rounding value
    (under float64 the flip's sign leaves it the same magnitude)."""
    def edit(x, g, ms):
        if flip:
            x[ms[0], 0, -1] = DOUBLE_ROUNDING
        else:
            _double_rounding(x, g, ms)
    tp.parity_vs_jax(PAIRS[cd], L, nr, C, flip, slab, edit)


def test_batch_rounds_once_to_float16():
    """A float64 batch value bound for float16 is rounded once, by the JAX
    package and by the plain versions (the kernels do the same,
    tests/test_torch_legendre_kernels.py): 1 + 2^-11 + 2^-40 becomes
    1 + 2^-10, not the 1 of two roundings, in a product and in a parity
    fold."""
    assert float(np.float32(DOUBLE_ROUNDING)) == 1.0 + 2.0 ** -11
    assert float(jax.jit(lambda a: a.astype(jnp.float16)
                         .astype(jnp.float64))(
        np.array([DOUBLE_ROUNDING]))[0]) == 1.0 + 2.0 ** -10
    lam = torch.ones((1, 1, 1), dtype=torch.float16)
    x = torch.tensor([DOUBLE_ROUNDING], dtype=torch.float64).reshape(1, 1, 1)
    assert float(lk.legendre_synth_tri(lam, x)) == 1.0 + 2.0 ** -10
    g = torch.tensor([DOUBLE_ROUNDING - 2.0 ** -12, 2.0 ** -12],
                     dtype=torch.float64).reshape(1, 2, 1)
    assert float(lk.legendre_adj_par(lam, g)) == 1.0 + 2.0 ** -10


def test_overflow_is_non_finite_where_jax_is():
    """A batch beyond float16's range (|x| > 65519.99) rounds to inf in
    both packages: the dense and parity contractions under float32 and
    float64 compute are non-finite at the same places as JAX's, and equal
    to them elsewhere (within the pair's tolerance)."""
    for cd, pair in PAIRS.items():
        L, nr, C = 9, 7, 4
        lam, x, g = tp.contraction_inputs(pair, L, nr, C, 5)
        x[4, 1, 6] = 7e4
        x[2, 0, 8] = -1e5
        g[5, 3, 2] = 65520.0
        g[1, 0, 0] = 6e4
        lt = lk.cast_to(torch.as_tensor(lam), pair.td)
        ref = tp.jax_tri(pair)(jnp.asarray(lam, pair.jtd), x, g)
        mine = (lk.legendre_synth_tri(lt, torch.as_tensor(x)),
                lk.legendre_adj_tri(lt, torch.as_tensor(g)))
        for a, r in zip(mine, ref):
            a, r = n(a), np.asarray(r)
            assert not np.isfinite(r).all()
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(r))
            fin = np.isfinite(r)
            assert (np.abs(a[fin] - r[fin]).max()
                    <= pair.tol * np.abs(r[fin]).max()), cd


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd", sorted(PAIRS))
@pytest.mark.parametrize("lmax,split,mode", [
    (16, False, "matmul"), (16, True, "matmul"), (31, False, "ct"),
    (31, True, "ct")])
def test_sht_matches_jax(cd, lmax, split, mode):
    """GL ``SHT`` spin 0 and 2, synthesis, adjoint and analysis, with
    float16 tables: dense and split (odd ring count: the equator row stays
    in the compute dtype, as in the JAX package), "matmul" and "ct" (lmax
    31: nphi 64 admits the factorization); under float32 each stage of the
    "matmul" transforms too."""
    pair = PAIRS[cd]
    grid = jax_gl(lmax)
    js = JaxSHT(grid, lmax, dtype=pair.jcd, spin2=True, fft_mode=mode,
                table_dtype=pair.jtd, ring_split=split)
    ts = SHT(gauss_legendre_grid(lmax), lmax, dtype=pair.cd, spin2=True,
             device="cpu", fft_mode=mode, table_dtype="float16",
             ring_split=split)
    assert ts.fft_mode == js.fft_mode == mode and ts.ring_split == split
    assert ts.table_dtype == torch.float16 and not ts.wide
    what = f"GL {lmax} {mode} split={split}"
    tp.compare_transforms(pair, js, ts, (grid.nrings, grid.nphi), what)
    if pair.flips and mode == "matmul":
        # (the "ct" stages round between their two matrix products, so a
        # flip can occur inside one of them)
        tp.compare_gl_stages(pair, js, ts, what)


@pytest.mark.parametrize("cd", sorted(PAIRS))
@pytest.mark.parametrize("layout,split", [("ring", False), ("padded", False),
                                          ("padded", True)])
def test_healpix_matches_jax(cd, layout, split):
    """``HealpixSHT`` at nside 8, lmax 16, with float16 tables and trig
    matrices, in the "ring" and "padded" layouts, dense and split."""
    pair = PAIRS[cd]
    js = jax_healpix(8, 16, dtype=pair.jcd, spin2=True, layout=layout,
                     table_dtype=pair.jtd, ring_split=split)
    ts = make_healpix_sht(8, 16, dtype=pair.cd, spin2=True, layout=layout,
                          device="cpu", table_dtype=np.float16,
                          ring_split=split)
    tp.compare_transforms(pair, js, ts, (ts.npix_layout,),
                          f"HEALPix {layout}")


@pytest.mark.parametrize("cd", sorted(PAIRS))
def test_points_match_jax(cd):
    """``PointSHT`` values and adjoints, spin 0 and 2, and the flat-slot
    per-bin values ``values_flat_spin0_gsel`` / ``values_flat_spin2_gsel``
    with and without a segment matrix, with float16 tables."""
    tp.compare_points(PAIRS[cd])


@pytest.mark.parametrize("cd", sorted(PAIRS))
def test_lsel_matches_jax(cd):
    """``_lsel_F`` through ``ring_cs_lsel_spin0`` / ``ring_cs_lsel_spin2``
    with float16 tables, with and without ``seg``: the grid rounded once,
    the product formed in float16, the segment sums in the compute
    dtype."""
    tp.compare_lsel(PAIRS[cd])


# ---------------------------------------------------------------------------
# the tolerance, and the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd", sorted(PAIRS))
def test_tolerance_discriminates(cd):
    """The comparisons above with the batch left unrounded (the plain
    versions contracting the compute-dtype batch with the widened table)
    miss the pair's tolerance: the dense contractions, the Legendre stage
    of the spin-0 synthesis and the whole spin-0 adjoint each miss it at
    more than 20% of their outputs (ten times the float32 flip allowance);
    and, under float64, the batch rounded twice (through float32) misses
    it at the double-rounding value."""
    pair = PAIRS[cd]
    lmax = 16
    js = JaxSHT(jax_gl(lmax), lmax, dtype=pair.jcd, table_dtype=pair.jtd)
    ts = make_sht(lmax, dtype=pair.cd, device="cpu", table_dtype="float16")
    x, f = tp.state_inputs(pair, lmax, (ts.nrings, ts.nphi), 3)[:2]
    g2 = np.asarray(tp.jit(lambda x: js._state_grids(x), x))
    lam, xk, gk = tp.contraction_inputs(pair, 17, 13, 5, 30)
    refs = (tp.jax_tri(pair)(jnp.asarray(lam, pair.jtd), xk, gk)
            + (tp.jit(lambda g: js._lsynth_stack(js.lam0, g), g2),
               tp.jit(lambda f: js.adjoint_synthesis_state(f), f)))
    lt = lk.cast_to(torch.as_tensor(lam), torch.float16)

    def mine():
        return (lk.legendre_synth_tri(lt, torch.as_tensor(xk)),
                lk.legendre_adj_tri(lt, torch.as_tensor(gk)),
                ts._lsynth_stack(ts.lam0, pair.t(g2)),
                ts.adjoint_synthesis_state(pair.t(f)))

    for a, r in zip(mine(), refs):
        pair.close(a, r, "port")
    unrounded = {
        "legendre_synth_tri_plain": lambda lam, b, ms=None: torch.einsum(
            "mlr,mcl->mrc", lam.to(b.dtype), b),
        "legendre_adj_tri_plain": lambda lam, b, ms=None: torch.einsum(
            "mlr,mrc->mcl", lam.to(b.dtype), b)}
    orig = {k: getattr(lk, k) for k in unrounded}
    try:
        for k, fn in unrounded.items():
            setattr(lk, k, fn)
        errs = [tp.rel_err(a, r) for a, r in zip(mine(), refs)]
    finally:
        for k, fn in orig.items():
            setattr(lk, k, fn)
    # ten times the float32 flip allowance (half of these outputs are the
    # zeros of l < m)
    frac = [float(np.mean(e > pair.tol)) for e in errs]
    assert min(frac) > 0.2, frac
    if cd == "float64":
        v = torch.tensor([DOUBLE_ROUNDING], dtype=torch.float64)
        one = lk.legendre_synth_tri(torch.ones((1, 1, 1), dtype=torch.float16),
                                    v.reshape(1, 1, 1))
        twice = v.to(torch.float16).double()
        assert abs(float(one) - float(twice)) > 1e6 * pair.tol


@pytest.mark.parametrize("cd", sorted(PAIRS))
def test_tables_are_float16(cd):
    """``make_sht(..., table_dtype=float16)`` stores every table in
    float16, each entry numpy's one rounding of the float64 table, the
    split's equator rows apart in the compute dtype; the DFT matrices hold
    float16 values."""
    tp.tables_hold_the_table_dtype(PAIRS[cd])


@pytest.mark.parametrize("cd", sorted(PAIRS))
def test_model_from_numpy_builds_jax_tables(cd):
    """``interop.model_from_numpy`` with ``"table_dtype": "float16"``
    builds the JAX model's float16 tables and DFT matrices bit for bit
    (JAX rounds float64 to float16 once, as numpy does)."""
    tp.model_tables_equal_jax(PAIRS[cd])


@pytest.mark.parametrize("cd", sorted(PAIRS))
def test_flagship_takes_float16_tables(cd):
    """``flagship.build`` (bench.py's BENCH_TABLE_DTYPE=float16; analytic
    proposal seeds at lmax 16) and ``flagship_sht`` on both grids take
    float16 tables: the full and cut transforms hold their tables in it."""
    from gibbssampler_tpu_torch import flagship
    pair = PAIRS[cd]
    scheme, _ = flagship.build("gl", "band", device="cpu", lmax=16,
                               dtype=pair.cd, table_dtype="float16",
                               seed=True)
    m = scheme.model
    for tr in (m.sht, m.cut_sht,
               flagship.flagship_sht("healpix", 16, "cpu", pair.cd,
                                     "float16")):
        assert tr.dtype == pair.cd and tr.table_dtype == torch.float16
        assert tr.lam_p2.dtype == torch.float16


# ---------------------------------------------------------------------------
# the band cut model: the W tables, ASIS steps (float32), cg_cr (float64)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def band():
    """{compute dtype name: (JAX cut model, port cut model, fields)}, built
    on first use."""
    cache = {}

    def get(cd):
        if cd not in cache:
            cache[cd] = tp.band_models(PAIRS[cd])
        return cache[cd]
    return get


@pytest.mark.parametrize("cd", sorted(PAIRS))
def test_table_engine_w_tables_match_jax(band, cd):
    """``_prepare_tchunks`` on the float16 cut tables: the tables keep
    their float16 values, and W is formed from the product of the table and
    the rounded weights (kept in float32 under float32 compute, rounded to
    float16 under float64, as the compiled JAX package forms it), against
    the JAX package's (with and without the Nyquist split)."""
    tp.w_tables_vs_jax(PAIRS[cd], *band(cd)[:2])


def test_cg_cr_fixed_iterations_match_jax(band):
    """``cg_cr`` of 3 chains for exactly 20 iterations on the band cut
    model with float16 tables under float64 compute, against JAX's, to
    1e-9 of max|ref| (the CG family's tolerance, tests/test_torch_cg.py)."""
    tp.cg_cr_vs_jax(PAIRS["float64"], *band("float64"), tol=1e-9)


@pytest.mark.filterwarnings("ignore:Explicitly requested dtype float64")
def test_asis_steps_match_jax(band):
    """Three ASIS iterations of 4 chains on the band cut model with float16
    tables under float32 compute (table engine), the JAX scheme's jitted
    vmapped step against the port's on the same pools and variates (as
    tests/test_torch_bf16.py's one step, with JAX's x64 off as the float32
    program runs): the CR and MH accepts equal, the state and D_ell within
    2e-4 of max|ref| (``table_pairs.asis_steps_vs_jax``)."""
    pair = PAIRS["float32"]
    jax.config.update("jax_enable_x64", False)
    try:
        tp.asis_steps_vs_jax(pair, *tp.band_models(pair), n_steps=3)
    finally:
        jax.config.update("jax_enable_x64", True)
