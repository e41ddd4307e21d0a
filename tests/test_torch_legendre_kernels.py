"""The port's triangular Legendre contractions against the Pallas kernels
of the JAX package (interpret mode), the float32 kernels' 3xTF32 numerical
model on the CPU, the wrappers' layout contract, and the CUDA kernels
against their plain versions on the card, in the full-table and the
m-slab form.

On the machine with the card run
``python -m pytest --noconftest tests/test_torch_legendre_kernels.py``
(without the JAX package's conftest); where jax is not installed the
Pallas comparisons skip."""

import numpy as np
import pytest
import torch

from torch_parity import cuda_device, n, t64, tri_table  # noqa: F401
from gibbssampler_tpu_torch.parallel import m_rows
from gibbssampler_tpu_torch.sht import gauss_legendre_grid
from gibbssampler_tpu_torch.sht import legendre_kernels as lk
from gibbssampler_tpu_torch.sht.legendre import spin2_lambda_tables


def _pallas():
    """(jnp, the JAX package's Pallas module); skips without jax."""
    jnp = pytest.importorskip("jax.numpy")
    return jnp, pytest.importorskip("gibbssampler_tpu.sht.pallas_legendre")


# (L, nr, C, Pallas tile): tests/test_pallas.py's shapes with its tiles of
# 4, and a ragged shape whose prime sizes Pallas only tiles whole (its
# interpret mode pads partial edge blocks with NaN)
SHAPES = [(16, 12, 8, 4), (37, 19, 10, None)]


def _inputs(L, nr, C, integer=True):
    rng = np.random.default_rng(L)
    draw = ((lambda s: rng.integers(-3, 4, size=s).astype(np.float64))
            if integer else (lambda s: rng.normal(size=s)))
    return tri_table(L, nr, seed=L, integer=integer), draw((L, C, L)), \
        draw((L, nr, C))


def _state_views(x, g):
    """x and g as ``sht.lcore`` passes them: x the (m, C, l) view of
    (C, m, l) grids, g the (m, r, C) view of an (m, C, r) copy."""
    return (x.transpose(0, 1).contiguous().transpose(0, 1),
            g.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("L,nr,C,tile", SHAPES)
def test_synth_matches_pallas(L, nr, C, tile):
    # integer inputs: the Pallas kernels return float32, which then holds
    # every product and sum exactly, so float64 tolerance applies
    jnp, pallas = _pallas()
    lam, x, _ = _inputs(L, nr, C)
    tl, tr = (tile, tile) if tile else (L, nr)
    ref = pallas.legendre_synth_tri(jnp.asarray(lam), jnp.asarray(x),
                                    tile_l=tl, tile_r=tr, interpret=True)
    out = lk.legendre_synth_tri(t64(lam), t64(x))
    assert out.shape == (L, nr, C)
    np.testing.assert_allclose(n(out), n(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("L,nr,C,tile", SHAPES)
def test_adj_matches_pallas(L, nr, C, tile):
    jnp, pallas = _pallas()
    lam, _, g = _inputs(L, nr, C)
    tl, tr = (tile, tile) if tile else (L, nr)
    ref = pallas.legendre_adj_tri(jnp.asarray(lam), jnp.asarray(g),
                                  tile_l=tl, tile_r=tr, interpret=True)
    out = lk.legendre_adj_tri(t64(lam), t64(g))
    assert out.shape == (L, C, L)
    np.testing.assert_allclose(n(out), n(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("L,nr,C,tile", SHAPES)
def test_synth_adj_are_transposes(L, nr, C, tile):
    """<K1 x, y> = <x, K2 y>: the synthesis and the adjoint read one table."""
    lam, x, g = _inputs(L, nr, C, integer=False)
    x = x * (np.arange(L)[None, None, :] >= np.arange(L)[:, None, None])
    lhs = float((lk.legendre_synth_tri(t64(lam), t64(x)) * t64(g)).sum())
    rhs = float((t64(x) * lk.legendre_adj_tri(t64(lam), t64(g))).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


# ---------------------------------------------------------------------------
# the layout contract, on the CPU as on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,nr,C,tile", SHAPES)
def test_state_views_give_the_same_results(L, nr, C, tile):
    """The main path's strided views give what contiguous operands give,
    and the adjoint returns (C, L, L) memory."""
    lam, x, g = (t64(a) for a in _inputs(L, nr, C, integer=False))
    xv, gv = _state_views(x, g)
    assert not xv.is_contiguous() and not gv.is_contiguous()
    np.testing.assert_allclose(n(lk.legendre_synth_tri(lam, xv)),
                               n(lk.legendre_synth_tri(lam, x)),
                               rtol=0, atol=1e-12)
    out, outv = lk.legendre_adj_tri(lam, g), lk.legendre_adj_tri(lam, gv)
    np.testing.assert_allclose(n(outv), n(out), rtol=0, atol=1e-12)
    assert out.transpose(0, 1).is_contiguous()
    assert outv.transpose(0, 1).is_contiguous()


def _refused(L, nr, C):
    """(wrapper, lam, operand) cases of layouts the kernels refuse."""
    lam, x, g = (t64(a) for a in _inputs(L, nr, C, integer=False))
    return [
        # x with unit stride on c, not on l
        (lk.legendre_synth_tri, lam,
         x.transpose(1, 2).contiguous().transpose(1, 2)),
        # g with unit stride on m only
        (lk.legendre_adj_tri, lam, g.permute(1, 2, 0).contiguous()
         .permute(2, 0, 1)),
        # a table that is not contiguous
        (lk.legendre_synth_tri, lam.transpose(1, 2).contiguous()
         .transpose(1, 2), x),
        (lk.legendre_adj_tri, lam.transpose(0, 1).contiguous()
         .transpose(0, 1), g),
    ]


@pytest.mark.parametrize("case", range(4))
def test_refused_layouts_raise_on_cpu(case):
    fn, lam, b = _refused(7, 5, 3)[case]
    with pytest.raises(ValueError):
        fn(lam, b)


# ---------------------------------------------------------------------------
# the float32 kernels' numerical model (3xTF32), emulated on the CPU
# ---------------------------------------------------------------------------

def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 values: round to nearest, ties away
    from zero, on the 13 low mantissa bits (an integer add and mask on the
    bits, as the kernels compute it)."""
    bits = a.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a: torch.Tensor):
    hi = _tf32_rna(a)
    return hi.double(), _tf32_rna(a - hi).double()


def _three_tf32(eq, a, b):
    """einsum of float32 operands as the tensor cores form it: the three
    TF32 products a_hi b_lo + a_lo b_hi + a_hi b_hi of the split (each exact
    in float32), summed here in float64 to isolate the split's error."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


@pytest.mark.parametrize("table", ["+2", "-2"])
def test_3xtf32_split_error_is_far_below_card_tolerance(table):
    """The lmax-64 spin-2 tables and normal batches: the split keeps the
    synthesis and the adjoint within 1e-6 max|ref| of the exact sums over
    the same float32 operands, and the pair adjoint to 1e-6, below a true
    float32 einsum's rounding of the same sums.  The card tolerance of
    1e-5 max|ref| (chip_smoke phase 3, the cuda cases below) leaves the rest
    to the fp32 accumulation, which the kernels keep short: a fresh
    tensor-core accumulator for each 32-deep stage, added to fp32 sums."""
    lmax = 64
    L, C = lmax + 1, 8
    lam = spin2_lambda_tables(lmax, gauss_legendre_grid(lmax).theta)[
        0 if table == "+2" else 1]
    nr = lam.shape[2]
    rng = np.random.default_rng(7)
    lam32, x32, y32 = (torch.as_tensor(a, dtype=torch.float32) for a in (
        lam, rng.normal(size=(L, C, L)), rng.normal(size=(L, nr, C))))
    for eq, b in (("mlr,mcl->mrc", x32), ("mlr,mrc->mcl", y32)):
        exact = torch.einsum(eq, lam32.double(), b.double())
        scale = float(exact.abs().max())
        err = float((_three_tf32(eq, lam32, b) - exact).abs().max()) / scale
        fp32 = float((torch.einsum(eq, lam32, b).double() - exact)
                     .abs().max()) / scale
        # ~1e-7 here: below a true float32 einsum's own rounding (~2.5e-7)
        assert err <= 1e-6 and err <= fp32, (eq, err, fp32)
    lhs = float((_three_tf32("mlr,mcl->mrc", lam32, x32) * y32.double()).sum())
    rhs = float((x32.double() * _three_tf32("mlr,mrc->mcl", lam32, y32)).sum())
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10   # TF32 spacing on [1, 2)
    a = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      -(1 + ulp / 2), 1 + 1.5 * ulp], dtype=torch.float32)
    assert _tf32_rna(a).tolist() == [1.0, 1 + ulp, 1.0, -(1 + ulp),
                                     1 + 2 * ulp]
    hi, lo = _split(a)
    assert torch.all((hi + lo - a.double()).abs()
                     <= 2.0 ** -22 * a.double().abs())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# in both dtypes: the last two are the CG phase's shapes (8 chains x
# Re/Im), where the mixed ladder's float32 apply runs too
CARD_SHAPES = [(16, 12, 8), (37, 19, 10), (513, 65, 256), (513, 65, 200),
               (513, 513, 256), (513, 65, 16), (513, 513, 16)]
# float64 alone: the CG phase's cut rings at 16 chains, an even L with odd
# nr (the odd m's table slabs start off a 16-byte boundary), and ragged
# column counts
F64_CARD_SHAPES = [(513, 65, 32), (64, 33, 16), (37, 19, 1), (37, 19, 17)]
DTYPES = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "state views"])
@pytest.mark.parametrize(
    "L,nr,C,dtype,rtol",
    [(*s, *d) for s in CARD_SHAPES for d in DTYPES]
    + [(*s, *DTYPES[1]) for s in F64_CARD_SHAPES])
def test_cuda_kernels_match_plain(cuda_device, L, nr, C, dtype, rtol, layout):
    """Kernel against plain einsum on the card; max |err| <= rtol max |ref|
    (float32: 3xTF32 tensor cores against true float32), and <K1 x, y> =
    <x, K2 y> to rtol.  The plain version runs in true float32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    lam = torch.randn((L, L, nr), generator=gen, dtype=dtype,
                      device=cuda_device)
    lam = (lam * (torch.arange(L, device=cuda_device)[None, :, None]
                  >= torch.arange(L, device=cuda_device)[:, None, None])
           ).contiguous()
    x = torch.randn((L, C, L), generator=gen, dtype=dtype, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, dtype=dtype, device=cuda_device)
    if layout == "state views":
        x, g = _state_views(x, g)
    lk.reset_launch_counts()
    for kern, plain, b, shape in ((lk.legendre_synth_tri,
                                   lk.legendre_synth_tri_plain, x,
                                   (L, nr, C)),
                                  (lk.legendre_adj_tri,
                                   lk.legendre_adj_tri_plain, g,
                                   (C, L, L))):
        # leave NaN garbage in the memory the output will be given: the
        # kernel must write every element, the adjoint's zeros of l < m too
        torch.full(shape, float("nan"), dtype=dtype, device=cuda_device)
        out = kern(lam, b)
        ref = plain(lam, b)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        assert err <= rtol * float(ref.abs().max()), (kern.__name__, err)
    assert (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches) \
        == (1, 1)
    y = lk.legendre_synth_tri_plain(lam, x) + g
    lhs = float((lk.legendre_synth_tri(lam, x).double() * y.double()).sum())
    rhs = float((x.double() * lk.legendre_adj_tri(lam, y).double()).sum())
    assert abs(lhs - rhs) <= rtol * abs(lhs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(4))
def test_cuda_wrappers_refuse(cuda_device, case):
    fn, lam, b = _refused(7, 5, 3)[case]
    with pytest.raises(ValueError):
        fn(lam.to(cuda_device), b.to(cuda_device))
    lam, x, _ = (torch.as_tensor(a, device=cuda_device)
                 for a in _inputs(7, 5, 3, integer=False))
    with pytest.raises(TypeError):
        lk.legendre_synth_tri(lam.to(torch.bfloat16), x.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_slab_kernels_match_plain(cuda_device, dtype):
    """Both kernels in their m-slab form on the card: each process's rows
    of the two-way and four-way splits (parallel.m_rows) at L 33 against
    the plain slab versions, on a table with garbage in its l < m
    triangle, which neither reads."""
    L, nr, C = 33, 19, 16
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    lam = torch.randn((L, L, nr), generator=gen, dtype=dtype,
                      device=cuda_device)
    x = torch.randn((L, C, L), generator=gen, dtype=dtype, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, dtype=dtype,
                    device=cuda_device)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n_m in (2, 4):
        for rows in m_rows(L, n_m):
            ms = torch.as_tensor(rows, dtype=torch.int32, device=cuda_device)
            idx = ms.long()
            for kern, plain, b in (
                    (lk.legendre_synth_tri, lk.legendre_synth_tri_plain, x),
                    (lk.legendre_adj_tri, lk.legendre_adj_tri_plain, g)):
                out = kern(lam[idx].contiguous(), b[idx].contiguous(), ms)
                ref = plain(lam[idx].contiguous(), b[idx].contiguous(), ms)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max() / ref.abs().max())
                assert err <= tol, (kern.__name__, n_m, rows, err)


# the parity modes on the card: (L, nr, C) with odd and even nr (the
# equator row or none), a tile's ragged edges, 1 and 17 columns; then the
# float32 synthesis' ring tiles (f32_par_synth_tile) across one and two
# tile boundaries (nh 90: two tiles of 64; nh 178: three) at two column
# tiles of 128 (C 200, 136), and the float64 synthesis' column tiles C 16,
# 32 and 48 (a whole 32-column tile and a partial one) with its ring tiles
# (nh 150: two tiles of 5 warps); then the float32 adjoint's tiles of 256
# rows l (both parities) by 64 columns over 32-ring stages: L - m over three
# row tiles with a last one of unequal parity counts (L 531) and over two
# (L 300), a row tile of one row (L 257), C across column tiles (72, 130),
# nh 33 (one ring past a stage, nr odd and even) and 32 (one whole stage);
# then the float64 adjoint's tiles of 128 rows l (64 of each class) by 8,
# 16 or 32 columns over 32-ring stages from ring -1 or 0: L - m over two
# row tiles with unequal class counts (L 201, odd) and equal ones (L 130,
# even), over four (L 385), at C 8, 16 and 48 (a 32-column tile and a
# 16-column part), nh 49 (a second stage), 65 (a third, nr even) and 16
PAR_CARD_SHAPES = [(16, 12, 8), (37, 19, 10), (65, 65, 40), (64, 33, 17),
                   (33, 18, 1), (40, 179, 200), (40, 356, 136),
                   (24, 66, 16), (37, 65, 32), (33, 300, 48),
                   (531, 65, 72), (300, 66, 130), (257, 64, 64),
                   (201, 97, 8), (130, 130, 16), (385, 31, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L,nr,C", PAR_CARD_SHAPES)
def test_cuda_parity_kernels_match_plain(cuda_device, L, nr, C, dtype):
    """The parity kernels (full table and the two-way split's slabs, with
    and without flip, g with unit stride on r and on c) against their plain
    versions on the card, the outputs given NaN-filled memory; each call
    counted in the parity wrappers' counts, none in the dense ones'."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    nh = (nr + 1) // 2
    lam = torch.randn((L, L, nh), generator=gen, dtype=dtype,
                      device=cuda_device)
    lam = (lam * (torch.arange(L, device=cuda_device)[None, :, None]
                  >= torch.arange(L, device=cuda_device)[:, None, None])
           ).contiguous()
    x = torch.randn((L, C, L), generator=gen, dtype=dtype, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, dtype=dtype, device=cuda_device)
    xv, gv = _state_views(x, g)
    lk.reset_launch_counts()
    calls = 0
    for ms in [None] + [torch.as_tensor(r, dtype=torch.int32,
                                        device=cuda_device)
                        for r in m_rows(L, 2)]:
        sel = (lambda t: t) if ms is None else (
            lambda t: t.index_select(0, ms.long()).contiguous())
        for flip in (False, True):
            cases = [(lk.legendre_synth_par, lk.legendre_synth_par_plain,
                      sel(xv) if ms is not None else xv, (nr,),
                      (L, nr, C))]
            for gl in (g, gv):
                cases.append((lk.legendre_adj_par, lk.legendre_adj_par_plain,
                              sel(gl) if ms is None else
                              _state_views(x, sel(gl))[1], (), (C, L, L)))
            for kern, plain, b, args, shape in cases:
                torch.full(shape, float("nan"), dtype=dtype,
                           device=cuda_device)
                out = kern(sel(lam), b, *args, flip, ms)
                ref = plain(sel(lam), b, *args, flip, ms)
                torch.cuda.synchronize()
                calls += 1
                err = float((out - ref).abs().max())
                assert bool(torch.isfinite(out).all())
                assert err <= tol * float(ref.abs().max()), (
                    kern.__name__, ms is None, flip, err)
    assert (lk.legendre_synth_par.launches + lk.legendre_adj_par.launches,
            lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches) \
        == (calls, 0, 0)


# (nr: (ring tile, tiles, padded rings)) of the bfloat16 dense synthesis at
# the ring counts of PERF.md's bf16 table and of the card tests
BF16_TILE_PLAN = {12: (80, 1, 68), 18: (80, 1, 62), 19: (80, 1, 61),
                  33: (80, 1, 47), 65: (80, 1, 15), 81: (96, 1, 15),
                  83: (96, 1, 13), 129: (144, 1, 15), 145: (80, 2, 15),
                  193: (128, 2, 63), 211: (128, 2, 45), 391: (144, 3, 41),
                  513: (144, 4, 63), 1023: (128, 8, 1)}


@pytest.mark.parametrize("nr", sorted(BF16_TILE_PLAN))
def test_bf16_synth_tile_plan(nr):
    """The ring tile that the host picks for the bfloat16 dense synthesis:
    the fewest tiles (each reads the batch again), then the least padding;
    one tile for every nr up to the largest tile."""
    tile = lk.bf16_synth_tile(nr)
    n = -(-nr // tile)
    assert (tile, n, n * tile - nr) == BF16_TILE_PLAN[nr]
    if nr <= max(lk.BF16_SYNTH_TILES):
        assert n == 1
    for t in lk.BF16_SYNTH_TILES:
        nt = -(-nr // t)
        assert (nt, nt * t) >= (n, n * tile), t


# (nh: (ring tile, tiles, padded rings)) of the float32 parity synthesis at
# the north ring counts of PERF.md's ring-parity table (nr 513, 1023) and
# of the card tests (PAR_CARD_SHAPES)
F32_PAR_TILE_PLAN = {6: (64, 1, 58), 9: (64, 1, 55), 10: (64, 1, 54),
                     17: (64, 1, 47), 33: (64, 1, 31), 90: (64, 2, 38),
                     150: (80, 2, 10), 178: (64, 3, 14), 257: (88, 3, 7),
                     512: (88, 6, 16)}


@pytest.mark.parametrize("nh", sorted(F32_PAR_TILE_PLAN))
def test_f32_par_synth_tile_plan(nh):
    """The ring tile that the host picks for the float32 parity synthesis:
    the fewest tiles (each stages the batch again), then the least
    padding; one tile for every nh up to the largest tile; the card tests'
    nh cover every count of tiles up to three."""
    tile = lk.f32_par_synth_tile(nh)
    n = -(-nh // tile)
    assert (tile, n, n * tile - nh) == F32_PAR_TILE_PLAN[nh]
    if nh <= max(lk.F32_PAR_SYNTH_TILES):
        assert n == 1
    for t in lk.F32_PAR_SYNTH_TILES:
        nt = -(-nh // t)
        assert (nt, nt * t) >= (n, n * tile), t
    card = {(nr + 1) // 2 for _, nr, _ in PAR_CARD_SHAPES}
    assert {-(-h // lk.f32_par_synth_tile(h)) for h in card} == {1, 2, 3}


# the parity shapes; then nr 83 (one tile of 96) and 193 (two of 128) at a
# partial column tile (C 200), nr just above the tile boundaries 128 (one
# tile of 144), 144 (two of 80) and 80 (one of 96), the last at an L whose
# rows split over two row tiles of the parity adjoint, unevenly by parity;
# then the dense adjoint's tiles of 256 rows l (both groups of 128) by 64
# columns over stages of 32 rings from ring -1: L - m over three row tiles
# with a last one of unequal group counts (L 531) and over two (L 300), C
# across column tiles (72, 130), nr 63 / 64 (the last ring in a second /
# third stage) and 31 / 32 (one stage / two); then the parity synthesis'
# ring tiles (bf16_par_synth_tile): one of 144 (nh 129), two of 128 (nh
# 145) and of 144 (nh 257), three of 128 (nh 289), at a partial column
# tile (C 136) and over stages of 32 degrees with an odd last one (L 33, 70)
BF16_CARD_SHAPES = PAR_CARD_SHAPES[:5] + [(97, 83, 200), (64, 193, 200),
                                      (40, 129, 16), (40, 145, 16),
                                      (301, 81, 200), (531, 63, 72),
                                      (300, 64, 130), (130, 32, 8),
                                      (129, 31, 16), (48, 257, 24),
                                      (70, 289, 136), (33, 513, 16),
                                      (24, 577, 40)]


# (nh: (ring tile, tiles, padded rings)) of the bfloat16 parity synthesis
# at the north ring counts of PERF.md's bf16 table (nr 513, 1023) and of the
# card tests (BF16_CARD_SHAPES)
BF16_PAR_TILE_PLAN = {6: (128, 1, 122), 9: (128, 1, 119),
                      10: (128, 1, 118), 16: (128, 1, 112),
                      17: (128, 1, 111), 32: (128, 1, 96), 33: (128, 1, 95),
                      41: (128, 1, 87), 42: (128, 1, 86), 65: (128, 1, 63),
                      73: (128, 1, 55), 97: (128, 1, 31), 129: (144, 1, 15),
                      145: (128, 2, 111), 257: (144, 2, 31),
                      289: (128, 3, 95), 512: (128, 4, 0)}


@pytest.mark.parametrize("nh", sorted(BF16_PAR_TILE_PLAN))
def test_bf16_par_synth_tile_plan(nh):
    """The ring tile that the host picks for the bfloat16 parity synthesis:
    the fewest tiles (each stages the batch again), then the least
    padding; one tile for every nh up to the largest tile; the card tests'
    nh cover every count of tiles up to three."""
    tile = lk.bf16_par_synth_tile(nh)
    n = -(-nh // tile)
    assert (tile, n, n * tile - nh) == BF16_PAR_TILE_PLAN[nh]
    if nh <= max(lk.BF16_PAR_SYNTH_TILES):
        assert n == 1
    for t in lk.BF16_PAR_SYNTH_TILES:
        nt = -(-nh // t)
        assert (nt, nt * t) >= (n, n * tile), t
    card = {(nr + 1) // 2 for _, nr, _ in BF16_CARD_SHAPES}
    assert card <= set(BF16_PAR_TILE_PLAN)
    assert {-(-h // lk.bf16_par_synth_tile(h)) for h in card} == {1, 2, 3}


@pytest.mark.cuda
@pytest.mark.parametrize("L,nr,C", BF16_CARD_SHAPES)
def test_cuda_bf16_kernels_match_plain(cuda_device, L, nr, C):
    """The bfloat16-table kernels, dense and parity (flip and not), on the
    full table and the two-way split's slabs, g with unit stride on r and
    on c, against their plain versions on the card (1e-5 max|ref|: the
    same exact products, float32 sums), the float32 outputs given
    NaN-filled memory; each launch counted in ``launches_bf16`` too."""
    _cuda_16bit_tables(cuda_device, torch.bfloat16, L, nr, C)


@pytest.mark.cuda
@pytest.mark.parametrize("L,nr,C", BF16_CARD_SHAPES)
def test_cuda_f16_kernels_match_plain(cuda_device, L, nr, C):
    """The float16-table kernels (the bfloat16 source in its float16 mode),
    as ``test_cuda_bf16_kernels_match_plain``: 1e-5 max|ref|, each launch
    counted in ``launches_f16``."""
    _cuda_16bit_tables(cuda_device, torch.float16, L, nr, C)


def _cuda_16bit_tables(cuda_device, td, L, nr, C):
    """The kernels of a 16-bit table ``td`` with a float32 batch against
    their plain versions (``test_cuda_bf16_kernels_match_plain``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    tri = (torch.arange(L, device=cuda_device)[None, :, None]
           >= torch.arange(L, device=cuda_device)[:, None, None])
    nh = (nr + 1) // 2
    tabs = {n_: (torch.randn((L, L, n_), generator=gen, device=cuda_device)
                 * tri).to(td).contiguous() for n_ in (nr, nh)}
    x = torch.randn((L, C, L), generator=gen, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, device=cuda_device)
    xv, gv = _state_views(x, g)
    lk.reset_launch_counts()
    calls = 0
    for ms in [None] + [torch.as_tensor(r, dtype=torch.int32,
                                        device=cuda_device)
                        for r in m_rows(L, 2)]:
        sel = (lambda t: t) if ms is None else (
            lambda t: t.index_select(0, ms.long()).contiguous())
        xs = xv if ms is None else sel(xv)
        gls = [g, gv] if ms is None else [_state_views(x, sel(g))[1]]
        cases = [(lk.legendre_synth_tri, lk.legendre_synth_tri_plain,
                  tabs[nr], xs, (), (L, nr, C))]
        cases += [(lk.legendre_adj_tri, lk.legendre_adj_tri_plain, tabs[nr],
                   gl, (), (C, L, L)) for gl in gls]
        for flip in (False, True):
            cases.append((lk.legendre_synth_par, lk.legendre_synth_par_plain,
                          tabs[nh], xs, (nr, flip), (L, nr, C)))
            cases += [(lk.legendre_adj_par, lk.legendre_adj_par_plain,
                       tabs[nh], gl, (flip,), (C, L, L)) for gl in gls]
        for kern, plain, lam, b, args, shape in cases:
            torch.full(shape, float("nan"), device=cuda_device)
            out = kern(sel(lam), b, *args, ms)
            ref = plain(sel(lam), b, *args, ms)
            torch.cuda.synchronize()
            calls += 1
            assert out.dtype == torch.float32
            err = float((out - ref).abs().max())
            assert bool(torch.isfinite(out).all())
            assert err <= 1e-5 * float(ref.abs().max()), (
                kern.__name__, ms is None, args, err)
    attr = "launches_bf16" if td == torch.bfloat16 else "launches_f16"
    assert sum(getattr(f, attr) for f in (
        lk.legendre_synth_tri, lk.legendre_adj_tri, lk.legendre_synth_par,
        lk.legendre_adj_par)) == calls


# (L, nr, C) of the narrow-table float64 kernels on the card: odd and even
# L and nr (the parity pair's equator row and its absence), partial and
# whole column tiles of 16, more than one degree-row tile of 128 and more
# than one ring tile of 128; then the dense pair's DMMA design: column
# tiles of 8 (C 8), 32 (C 32) and more than one (C 40: 32 + 8), odd nr 65
# at L >= 64 (bfloat16 rows at every 2-byte shift of a 16-byte chunk, one
# ring tile of 5 warps of 16 rings), nr 129, 257 and 513 (warps of 32
# rings: one, two and three synthesis ring tiles), adjoint row tiles of
# 256 rows l more than one (L 300, and L 258 with a 2-row last tile at m 0
# and 1, nr 16 even) and odd slabs of the two-way split (L 33: 17 and 16
# rows; L 37: 19 and 18) for the synthesis' rows i and M-1-i; then the
# parity pair's DMMA design (narrow_par_synth_plan): nh 289 (odd: a class's
# bfloat16 rows at every shift; 2 ring tiles of 5 warps of 32 rings), nh
# 258 at 32 columns (3 tiles of 6 warps of 16), nh 129 at a partial tile of
# 32 columns (2 tiles of 5 warps; L 35: slabs of 18 and 17 rows), nr 514
# (nh 257, no equator ring), the grid's nh 257 at 32 columns, and three
# adjoint row tiles of 256 rows l (L 531) at C 40
NARROW_CARD_SHAPES = [(17, 13, 5), (37, 19, 17), (64, 33, 16),
                      (160, 257, 33), (64, 65, 8), (300, 65, 32),
                      (33, 129, 40), (258, 16, 16), (37, 65, 16),
                      (20, 513, 8), (20, 577, 16), (24, 515, 32),
                      (35, 257, 24), (40, 514, 16), (70, 513, 32),
                      (531, 33, 40)]


# ((nh, C): (ring tiles, warps a block, rings a warp)) of the narrow-table
# float64 parity synthesis at the grid's nh 257 (nr 513) and 512 (nr 1023)
# and at the card tests' (NARROW_CARD_SHAPES)
NARROW_PAR_PLAN = {(257, 16): (2, 5, 32), (257, 32): (3, 6, 16),
                   (512, 16): (3, 6, 32), (512, 32): (6, 6, 16),
                   (7, 5): (1, 1, 16), (10, 17): (1, 1, 16),
                   (17, 16): (1, 2, 16), (129, 33): (2, 5, 16),
                   (33, 8): (1, 3, 16), (33, 32): (1, 3, 16),
                   (65, 40): (1, 5, 16), (8, 16): (1, 1, 16),
                   (257, 8): (2, 5, 32), (289, 16): (2, 5, 32),
                   (258, 32): (3, 6, 16), (129, 24): (2, 5, 16),
                   (33, 16): (1, 3, 16), (17, 40): (1, 2, 16),
                   (96, 16): (1, 6, 16), (97, 16): (1, 4, 32),
                   (128, 16): (1, 4, 32), (96, 32): (1, 6, 16),
                   (97, 32): (2, 4, 16)}


@pytest.mark.parametrize("nh,C", sorted(NARROW_PAR_PLAN))
def test_narrow_par_synth_plan(nh, C):
    """The ring tiles of the narrow-table float64 parity synthesis (the
    pure-Python mirror of its launcher's plan, held equal to it on the card
    by chip_smoke.py phase 2): warps of 16 rings at 32 columns and up to
    96 rings, else 32; the fewest ring tiles of at most 6 warps, of sizes
    that differ by at most one ring, with idle lanes only in a block's last
    warp; the card tests reach one, two and three tiles."""
    plan = lk.narrow_par_synth_plan(nh, C)
    tiles, warps, wr = NARROW_PAR_PLAN[(nh, C)]
    assert plan == {"ring_tiles": tiles, "warps": warps, "warp_rings": wr}
    assert wr == (16 if lk.narrow_col_tile("synth_par", 2, 2 * nh, C) == 32
                  or nh <= 96 else 32)
    sizes = [(t + 1) * nh // tiles - t * nh // tiles for t in range(tiles)]
    assert sum(sizes) == nh and max(sizes) - min(sizes) <= 1
    assert warps <= 6 and max(sizes) <= warps * wr
    assert (warps - 1) * wr <= min(sizes)
    assert tiles == 1 or -(-nh // wr) > 6 * (tiles - 1)
    card = {((nr + 1) // 2, C) for _, nr, C in NARROW_CARD_SHAPES}
    assert card <= set(NARROW_PAR_PLAN)
    assert {NARROW_PAR_PLAN[k][0] for k in card} == {1, 2, 3}


# float64 values that one rounding to float16 and two (through float32)
# take to different neighbours, ties and their neighbours, subnormals, the
# largest finite float16 and the first values that overflow it
F16_EDGES = (1.0 + 2.0 ** -11 + 2.0 ** -40, 1.0 + 2.0 ** -11 - 2.0 ** -40,
             -(1.0 + 2.0 ** -11 + 2.0 ** -40), 1.0 + 2.0 ** -11,
             1.0 + 3 * 2.0 ** -11, 2.0 ** -24, 2.0 ** -25 + 2.0 ** -60,
             2.0 ** -25, 3 * 2.0 ** -26, 2.0 ** -14 - 2.0 ** -25 + 2.0 ** -50,
             65504.0, 65519.99, 65520.0, -0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("td", [torch.bfloat16, torch.float32,
                                torch.float16])
@pytest.mark.parametrize("L,nr,C", NARROW_CARD_SHAPES)
def test_cuda_narrow_f64_kernels_match_plain(cuda_device, td, L, nr, C):
    """The narrow-table float64 kernels (bfloat16, float32 or float16
    table, float64 batch), dense and parity (flip and not), on the full
    table and the two-way split's slabs, g with unit stride on r and on c,
    against their plain versions on the card (1e-12 max|ref|: the same
    exact products, float64 sums), the float64 outputs given NaN-filled
    memory; each launch counted in ``launches_narrow`` and under the kernel
    dtype (td, float64).  The batch holds the values whose rounding to the
    table dtype tells one rounding from two (a float16 table: F16_EDGES but
    the overflowing ones, which ``test_cuda_f16f64_edge_values_bit_equal``
    checks)."""
    f64 = torch.float64
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    tri = (torch.arange(L, device=cuda_device)[None, :, None]
           >= torch.arange(L, device=cuda_device)[:, None, None])
    nh = (nr + 1) // 2
    tabs = {n_: (torch.randn((L, L, n_), generator=gen, dtype=f64,
                             device=cuda_device) * tri).to(td).contiguous()
            for n_ in (nr, nh)}
    x = torch.randn((L, C, L), generator=gen, dtype=f64, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, dtype=f64, device=cuda_device)
    x[L - 1, 0, L - 1] = 1.0 + 2.0 ** -8 + 2.0 ** -30
    if td == torch.float16:
        edges = torch.tensor(F16_EDGES[:-3], dtype=f64)
        x[L - 1, 0, L - len(edges):] = edges
        g[L - 1, : min(nr, len(edges)), 0] = edges[: min(nr, len(edges))]
    xv, gv = _state_views(x, g)
    lk.reset_launch_counts()
    calls = 0
    for ms in [None] + [torch.as_tensor(r, dtype=torch.int32,
                                        device=cuda_device)
                        for r in m_rows(L, 2)]:
        sel = (lambda t: t) if ms is None else (
            lambda t: t.index_select(0, ms.long()).contiguous())
        xs = xv if ms is None else sel(xv)
        gls = [g, gv] if ms is None else [_state_views(x, sel(g))[1]]
        cases = [(lk.legendre_synth_tri, lk.legendre_synth_tri_plain,
                  tabs[nr], xs, (), (L, nr, C))]
        cases += [(lk.legendre_adj_tri, lk.legendre_adj_tri_plain, tabs[nr],
                   gl, (), (C, L, L)) for gl in gls]
        for flip in (False, True):
            cases.append((lk.legendre_synth_par, lk.legendre_synth_par_plain,
                          tabs[nh], xs, (nr, flip), (L, nr, C)))
            cases += [(lk.legendre_adj_par, lk.legendre_adj_par_plain,
                       tabs[nh], gl, (flip,), (C, L, L)) for gl in gls]
        for kern, plain, lam, b, args, shape in cases:
            torch.full(shape, float("nan"), dtype=f64, device=cuda_device)
            out = kern(sel(lam), b, *args, ms)
            ref = plain(sel(lam), b, *args, ms)
            torch.cuda.synchronize()
            calls += 1
            assert out.dtype == f64
            err = float((out - ref).abs().max())
            assert bool(torch.isfinite(out).all())
            assert err <= 1e-12 * float(ref.abs().max()), (
                kern.__name__, ms is None, args, err)
    fns = (lk.legendre_synth_tri, lk.legendre_adj_tri, lk.legendre_synth_par,
           lk.legendre_adj_par)
    assert sum(f.launches_narrow for f in fns) == calls
    assert sum(f.launches_bf16 + f.launches_f64 for f in fns) == 0
    assert sum(v for f in fns for k, v in (*f.shapes.items(),
                                           *f.slabs.items())
               if k[-1] == (td, f64)) == calls


@pytest.mark.cuda
def test_cuda_f16f64_edge_values_bit_equal(cuda_device):
    """The float16-table float64 kernels on a batch of F16_EDGES (overflow
    included: the rounded batch holds inf), a table of ones on one row
    m = 0, so that each output is one product (no sum to reorder): every
    output equals numpy's float16 rounding of its value, finite or not,
    and so does the plain version's where that is finite (the plain
    versions, on the CPU: a BLAS product may turn an inf into a NaN)."""
    f64 = torch.float64
    edges = torch.tensor(F16_EDGES, dtype=f64, device=cuda_device)
    L, C = 1, len(F16_EDGES)
    lam = torch.ones((L, L, 1), dtype=torch.float16, device=cuda_device)
    x = edges.reshape(1, C, 1)
    g = edges.reshape(1, 1, C)
    with np.errstate(over="ignore"):
        want = torch.from_numpy(np.asarray(F16_EDGES).astype(np.float16)
                                .astype(np.float64))
    lc, xc, gc = lam.cpu(), x.cpu(), g.cpu()
    for out, ref in (
            (lk.legendre_synth_tri(lam, x), lk.legendre_synth_tri_plain(lc, xc)),
            (lk.legendre_adj_tri(lam, g), lk.legendre_adj_tri_plain(lc, gc)),
            (lk.legendre_synth_par(lam, x, 1),
             lk.legendre_synth_par_plain(lc, xc, 1)),
            (lk.legendre_adj_par(lam, g), lk.legendre_adj_par_plain(lc, gc))):
        a, b = out.reshape(-1).cpu(), ref.reshape(-1)
        fin = want.isfinite()
        assert torch.equal(a, want) and torch.equal(b[fin], want[fin]), (
            a, b, want)


@pytest.mark.cuda
@pytest.mark.parametrize("L,nr,C", NARROW_CARD_SHAPES)
def test_cuda_wide_kernels_match_plain(cuda_device, L, nr, C):
    """The float64-table kernels with a float32 batch (the narrow source's
    float64 mode), dense and parity (flip and not), on the full table and
    the two-way split's slabs, g with unit stride on r and on c, against
    their plain versions on the card: within one float32 ulp of max|ref|
    (both round float64 sums of the same products once to float32, the
    sums in other orders; the parity synthesis rounds each class's sums
    first and combines them in float32), the float32 outputs given
    NaN-filled memory; each launch counted in ``launches_wide`` and under
    the kernel dtype (float64, float32)."""
    f64, f32 = torch.float64, torch.float32
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    tri = (torch.arange(L, device=cuda_device)[None, :, None]
           >= torch.arange(L, device=cuda_device)[:, None, None])
    nh = (nr + 1) // 2
    tabs = {n_: (torch.randn((L, L, n_), generator=gen, dtype=f64,
                             device=cuda_device) * tri).contiguous()
            for n_ in (nr, nh)}
    x = torch.randn((L, C, L), generator=gen, dtype=f32, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, dtype=f32, device=cuda_device)
    xv, gv = _state_views(x, g)
    lk.reset_launch_counts()
    calls = 0
    for ms in [None] + [torch.as_tensor(r, dtype=torch.int32,
                                        device=cuda_device)
                        for r in m_rows(L, 2)]:
        sel = (lambda t: t) if ms is None else (
            lambda t: t.index_select(0, ms.long()).contiguous())
        xs = xv if ms is None else sel(xv)
        gls = [g, gv] if ms is None else [_state_views(x, sel(g))[1]]
        cases = [(lk.legendre_synth_tri, lk.legendre_synth_tri_plain,
                  tabs[nr], xs, (), (L, nr, C))]
        cases += [(lk.legendre_adj_tri, lk.legendre_adj_tri_plain, tabs[nr],
                   gl, (), (C, L, L)) for gl in gls]
        for flip in (False, True):
            cases.append((lk.legendre_synth_par, lk.legendre_synth_par_plain,
                          tabs[nh], xs, (nr, flip), (L, nr, C)))
            cases += [(lk.legendre_adj_par, lk.legendre_adj_par_plain,
                       tabs[nh], gl, (flip,), (C, L, L)) for gl in gls]
        for kern, plain, lam, b, args, shape in cases:
            torch.full(shape, float("nan"), dtype=f32, device=cuda_device)
            out = kern(sel(lam), b, *args, ms)
            ref = plain(sel(lam), b, *args, ms)
            torch.cuda.synchronize()
            calls += 1
            assert out.dtype == f32
            err = float((out - ref).abs().max())
            assert bool(torch.isfinite(out).all())
            assert err <= torch.finfo(f32).eps * float(ref.abs().max()), (
                kern.__name__, ms is None, args, err)
    fns = (lk.legendre_synth_tri, lk.legendre_adj_tri, lk.legendre_synth_par,
           lk.legendre_adj_par)
    assert sum(f.launches_wide for f in fns) == calls
    assert sum(f.launches_narrow + f.launches_f64 for f in fns) == 0
    assert sum(v for f in fns for k, v in (*f.shapes.items(),
                                           *f.slabs.items())
               if k[-1] == (f64, f32)) == calls


# (L, nr, C) of the float64 table's dense pair on the card, beyond
# NARROW_CARD_SHAPES' C <= 40 (wide_synth_plan, wide_adj_plan): the band's
# nr 65 at C 256 (synthesis: 2 ring tiles of 3 and 2 warps, 4 column warps;
# adjoint: 2 column tiles of 128), the grid's nr 513 at C 256 (9 ring tiles
# of 4 warps) with odd slabs of 19 and 18
# rows, C 64 with two adjoint row tiles of 128 rows l (L 150), a ragged C
# 200 (one synthesis column tile of 256, 4 ring tiles; adjoint 128 + 72),
# three adjoint row tiles (L 260) at C 100 (synthesis 2 column warps, 2
# ring tiles of 5 warps), C 40 (one column warp of 64) and C 16
WIDE_CARD_SHAPES = [(40, 65, 256), (37, 513, 256), (150, 33, 64),
                    (33, 200, 200), (260, 130, 100), (21, 17, 40),
                    (64, 65, 16)]

# ((nr, C): (synthesis ring tiles, warps a block, columns a block; adjoint
# columns a block)) of the float64 table's dense pair at the main path's
# shapes (the band's 65 rings, the planckish and HEALPix floors 83, 193,
# 211, 391, the GL and HEALPix grids 513, 1023, 128 chains) and the card
# tests' (WIDE_CARD_SHAPES)
WIDE_PLAN = {(65, 256): (2, 12, 256, 128), (83, 256): (2, 12, 256, 128),
             (193, 256): (4, 16, 256, 128), (211, 256): (4, 16, 256, 128),
             (391, 256): (7, 16, 256, 128), (513, 256): (9, 16, 256, 128),
             (1023, 256): (16, 16, 256, 128), (33, 64): (1, 3, 64, 64),
             (200, 200): (4, 16, 256, 128), (130, 100): (2, 10, 128, 128),
             (17, 40): (1, 2, 64, 64), (65, 16): (1, 5, 32, 32),
             (1, 1): (1, 1, 32, 32), (129, 64): (1, 9, 64, 64),
             (128, 65): (1, 16, 128, 128), (129, 65): (2, 10, 128, 128)}


@pytest.mark.parametrize("nr,C", sorted(WIDE_PLAN))
def test_wide_dense_plans(nr, C):
    """The tiles of the float64 table's dense synthesis and adjoint (the
    pure-Python mirrors of their launchers' plans, held equal to them on
    the card by chip_smoke.py phase 2): synthesis warps of 16 rings x 32 or
    64 columns, column warps enough for C (at most 4), at most 16 warps a
    block, the fewest ring tiles of sizes that differ by at most one ring
    with idle lanes only in a tile's last ring warp; adjoint blocks of 128
    rows l x 32, 64 or 128 columns (128 above 64 columns); narrow_col_tile
    gives the wide tiles for an 8-byte table only.  The card tests reach
    one and several ring and column tiles."""
    sp, ap = lk.wide_synth_plan(nr, C), lk.wide_adj_plan(nr, C)
    tiles, warps, tc, atc = WIDE_PLAN[(nr, C)]
    assert (sp["ring_tiles"], sp["warps"], sp["col_tile"]) == (tiles, warps,
                                                               tc)
    assert sp["warp_rings"] == 16 and warps <= lk.WIDE_SYNTH_WARPS
    cw = 32 if C <= 32 else 64
    wn = tc // cw
    assert 1 <= wn <= lk.WIDE_COL_WARPS and warps % wn == 0
    assert wn == lk.WIDE_COL_WARPS or tc >= C
    sizes = [(t + 1) * nr // tiles - t * nr // tiles for t in range(tiles)]
    wr = warps // wn
    assert max(sizes) - min(sizes) <= 1 and max(sizes) <= 16 * wr
    assert 16 * (wr - 1) < max(sizes)
    assert tiles == 1 or -(-nr // 16) > (tiles - 1) * (16 // wn)
    assert ap == {"rows": 128, "col_tile": atc, "warps": atc // 8}
    assert atc == (32 if C <= 32 else 128 if C > 64 else 64)
    assert lk.narrow_col_tile("synth", 8, nr, C) == tc
    assert lk.narrow_col_tile("adj", 8, nr, C) == atc
    for kind in ("synth", "adj", "synth_par", "adj_par"):
        assert lk.narrow_col_tile(kind, 2, nr, C) == min(max(
            8, 1 << (C - 1).bit_length()), 32)
    card = {(nr_, C_) for _, nr_, C_ in WIDE_CARD_SHAPES}
    assert card <= set(WIDE_PLAN)
    assert {WIDE_PLAN[k][0] > 1 for k in card} == {False, True}
    assert {WIDE_PLAN[k][3] for k in card} == {32, 64, 128}


@pytest.mark.cuda
@pytest.mark.parametrize("L,nr,C", WIDE_CARD_SHAPES)
def test_cuda_wide_dense_kernels_match_plain(cuda_device, L, nr, C):
    """The float64 table's dense synthesis and adjoint (float32 batch) at
    the wide tiles' shapes, on the full table and the two-way split's slabs,
    g with unit stride on r and on c, against their plain versions on the
    card: within one float32 ulp of max|ref| (float64 sums of the same
    exact products in other orders, each rounded once to float32), the
    float32 outputs given NaN-filled memory; each launch counted in
    ``launches_wide``."""
    f64, f32 = torch.float64, torch.float32
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    tri = (torch.arange(L, device=cuda_device)[None, :, None]
           >= torch.arange(L, device=cuda_device)[:, None, None])
    lam = (torch.randn((L, L, nr), generator=gen, dtype=f64,
                       device=cuda_device) * tri).contiguous()
    x = torch.randn((L, C, L), generator=gen, dtype=f32, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, dtype=f32, device=cuda_device)
    xv, gv = _state_views(x, g)
    lk.reset_launch_counts()
    calls = 0
    for ms in [None] + [torch.as_tensor(r, dtype=torch.int32,
                                        device=cuda_device)
                        for r in m_rows(L, 2)]:
        sel = (lambda t: t) if ms is None else (
            lambda t: t.index_select(0, ms.long()).contiguous())
        xs = xv if ms is None else sel(xv)
        gls = [g, gv] if ms is None else [g_ for g_ in (
            sel(g), _state_views(x, sel(g))[1])]
        cases = [(lk.legendre_synth_tri, lk.legendre_synth_tri_plain, xs,
                  (L, nr, C))]
        cases += [(lk.legendre_adj_tri, lk.legendre_adj_tri_plain, gl,
                   (C, L, L)) for gl in gls]
        for kern, plain, b, shape in cases:
            torch.full(shape, float("nan"), dtype=f32, device=cuda_device)
            out = kern(sel(lam), b, ms)
            ref = plain(sel(lam), b, ms)
            torch.cuda.synchronize()
            calls += 1
            assert out.dtype == f32
            err = float((out - ref).abs().max())
            assert bool(torch.isfinite(out).all())
            assert err <= torch.finfo(f32).eps * float(ref.abs().max()), (
                kern.__name__, ms is None, b.stride(), err)
    fns = (lk.legendre_synth_tri, lk.legendre_adj_tri)
    assert sum(f.launches_wide for f in fns) == calls
    assert sum(f.launches_narrow + f.launches_f64 for f in fns) == 0


# (L, nr, C) of the float64 table's parity pair on the card
# (wide_par_synth_plan, wide_par_adj_plan): the GL grid's nh 257 at C 256
# (synthesis: 9 ring tiles of 2 ring warps of each class, 4 column warps;
# adjoint: 2 column tiles of 128) with odd slabs of 19 and 18 rows, a ragged
# C 200 (one synthesis column tile of 256, 4 ring tiles; adjoint 128 + 72),
# C 64 with two adjoint row tiles of 128 rows l (L 150), an even nr at C 16
# (one column warp of 32), three adjoint row tiles (L 260) at an even nr
# and C 100 (synthesis 2 column warps, 2 ring tiles of 3 ring warps), the
# band's 65 rings at C 256 (2 ring tiles)
WIDE_PAR_CARD_SHAPES = [(37, 513, 256), (33, 201, 200), (150, 33, 64),
                        (21, 18, 16), (260, 130, 100), (40, 65, 256)]

# ((nr, C): (synthesis ring tiles, warps a block, columns a block; adjoint
# columns a block)) of the float64 table's parity pair at the main path's
# shapes (the GL grid's 513 rings and the HEALPix grid's 1023, 128 chains;
# 256 at 1023 rings and C 512) and the card tests' (WIDE_PAR_CARD_SHAPES),
# nr the output's or g's rings
WIDE_PAR_PLAN = {
    (513, 256): (9, 16, 256, 128), (1023, 256): (16, 16, 256, 128),
    (1024, 512): (16, 16, 256, 128), (201, 200): (4, 16, 256, 128),
    (33, 64): (1, 4, 64, 64), (18, 16): (1, 2, 32, 32),
    (130, 100): (2, 12, 128, 128), (65, 256): (2, 16, 256, 128),
    (1, 1): (1, 2, 32, 32), (2, 65): (1, 4, 128, 128),
    (129, 64): (1, 10, 64, 64), (257, 33): (2, 10, 64, 64),
    (64, 257): (1, 16, 256, 128)}


@pytest.mark.parametrize("nr,C", sorted(WIDE_PAR_PLAN))
def test_wide_par_plans(nr, C):
    """The tiles of the float64 table's parity synthesis and adjoint (the
    pure-Python mirrors of their launchers' plans, held equal to them on
    the card by chip_smoke.py phase 2): synthesis warps of one class' sums
    over 16 rings x 32 or 64 columns, a warp of each class for every 16
    rings x those columns, column warps enough for C (at most 4: all 256
    columns a block at C 256, so that the half table enters the SMs once
    per ring tile), at most 16 warps a block, the fewest ring tiles of the
    nh north rings, of sizes that differ by at most one ring with idle
    lanes only in a tile's last ring warp; adjoint blocks of 128 rows l
    (64 of each class) x 32, 64 or 128 columns (128 above 64 columns: the
    table enters the SMs twice at C 256); narrow_col_tile gives the wide
    tiles for an 8-byte table only.  The card tests reach one and several
    ring, column and row tiles."""
    nh = (nr + 1) // 2
    sp, ap = lk.wide_par_synth_plan(nh, C), lk.wide_par_adj_plan(nr, C)
    tiles, warps, tc, atc = WIDE_PAR_PLAN[(nr, C)]
    assert (sp["ring_tiles"], sp["warps"], sp["col_tile"]) == (tiles, warps,
                                                               tc)
    assert sp["warp_rings"] == 16 and warps <= lk.WIDE_SYNTH_WARPS
    cw = 32 if C <= 32 else 64
    wn = tc // cw
    assert 1 <= wn <= lk.WIDE_PAR_COL_WARPS and warps % (2 * wn) == 0
    assert wn == lk.WIDE_PAR_COL_WARPS or tc >= C
    sizes = [(t + 1) * nh // tiles - t * nh // tiles for t in range(tiles)]
    wr = warps // (2 * wn)
    assert max(sizes) - min(sizes) <= 1 and max(sizes) <= 16 * wr
    assert 16 * (wr - 1) < max(sizes)
    assert tiles == 1 or -(-nh // 16) > (tiles - 1) * (8 // wn)
    assert ap == {"rows": 128, "col_tile": atc, "warps": atc // 8}
    assert atc == (32 if C <= 32 else 128 if C > 64 else 64)
    assert lk.narrow_col_tile("synth_par", 8, nr, C) == tc
    assert lk.narrow_col_tile("adj_par", 8, nr, C) == atc
    if C == 256:  # the main path's: the table enters the SMs once per
        assert (tc, atc) == (256, 128)  # ring tile, twice per row tile
    card = {(nr_, C_) for _, nr_, C_ in WIDE_PAR_CARD_SHAPES}
    assert card <= set(WIDE_PAR_PLAN)
    assert {WIDE_PAR_PLAN[k][0] > 1 for k in card} == {False, True}
    assert {WIDE_PAR_PLAN[k][3] for k in card} == {32, 64, 128}
    assert {k[0] % 2 for k in card} == {0, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("L,nr,C", WIDE_PAR_CARD_SHAPES)
def test_cuda_wide_par_kernels_match_plain(cuda_device, L, nr, C):
    """The float64 table's parity synthesis and adjoint (float32 batch) at
    the wide parity tiles' shapes, flip and not, on the full table and the
    two-way split's slabs, g with unit stride on r and on c, against their
    plain versions on the card: within one float32 ulp of max|ref| (float64
    sums of the same exact products in other orders, each class's rounded
    once to float32 before the synthesis combines them; the adjoint's fold
    formed in float32 and widened), the float32 outputs given NaN-filled
    memory; each launch counted in ``launches_wide``."""
    f64, f32 = torch.float64, torch.float32
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    tri = (torch.arange(L, device=cuda_device)[None, :, None]
           >= torch.arange(L, device=cuda_device)[:, None, None])
    lam = (torch.randn((L, L, (nr + 1) // 2), generator=gen, dtype=f64,
                       device=cuda_device) * tri).contiguous()
    x = torch.randn((L, C, L), generator=gen, dtype=f32, device=cuda_device)
    g = torch.randn((L, nr, C), generator=gen, dtype=f32, device=cuda_device)
    xv, gv = _state_views(x, g)
    lk.reset_launch_counts()
    calls = 0
    for ms in [None] + [torch.as_tensor(r, dtype=torch.int32,
                                        device=cuda_device)
                        for r in m_rows(L, 2)]:
        sel = (lambda t: t) if ms is None else (
            lambda t: t.index_select(0, ms.long()).contiguous())
        xs = xv if ms is None else sel(xv)
        gls = [g, gv] if ms is None else [g_ for g_ in (
            sel(g), _state_views(x, sel(g))[1])]
        for flip in (False, True):
            cases = [(lk.legendre_synth_par, lk.legendre_synth_par_plain, xs,
                      (nr, flip), (L, nr, C))]
            cases += [(lk.legendre_adj_par, lk.legendre_adj_par_plain, gl,
                       (flip,), (C, L, L)) for gl in gls]
            for kern, plain, b, args, shape in cases:
                torch.full(shape, float("nan"), dtype=f32,
                           device=cuda_device)
                out = kern(sel(lam), b, *args, ms)
                ref = plain(sel(lam), b, *args, ms)
                torch.cuda.synchronize()
                calls += 1
                assert out.dtype == f32
                err = float((out - ref).abs().max())
                assert bool(torch.isfinite(out).all())
                assert err <= torch.finfo(f32).eps * float(ref.abs().max()), (
                    kern.__name__, ms is None, flip, b.stride(), err)
    fns = (lk.legendre_synth_par, lk.legendre_adj_par)
    assert sum(f.launches_wide for f in fns) == calls
    assert sum(f.launches_narrow + f.launches_f64 for f in fns) == 0
