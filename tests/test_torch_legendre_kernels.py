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
# equator row or none), a tile's ragged edges, 1 and 17 columns
PAR_CARD_SHAPES = [(16, 12, 8), (37, 19, 10), (65, 65, 40), (64, 33, 17),
                   (33, 18, 1)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("L,nr,C", PAR_CARD_SHAPES)
def test_cuda_bf16_kernels_match_plain(cuda_device, L, nr, C):
    """The bfloat16-table kernels, dense and parity (flip and not), on the
    full table and the two-way split's slabs, g with unit stride on r and
    on c, against their plain versions on the card (1e-5 max|ref|: the
    same exact products, float32 sums), the float32 outputs given
    NaN-filled memory; each launch counted in ``launches_bf16`` too."""
    gen = torch.Generator(device=cuda_device).manual_seed(L + nr + C)
    tri = (torch.arange(L, device=cuda_device)[None, :, None]
           >= torch.arange(L, device=cuda_device)[:, None, None])
    nh = (nr + 1) // 2
    tabs = {n_: (torch.randn((L, L, n_), generator=gen, device=cuda_device)
                 * tri).to(torch.bfloat16).contiguous() for n_ in (nr, nh)}
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
    assert sum(f.launches_bf16 for f in (
        lk.legendre_synth_tri, lk.legendre_adj_tri, lk.legendre_synth_par,
        lk.legendre_adj_par)) == calls
