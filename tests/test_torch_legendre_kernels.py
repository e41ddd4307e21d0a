"""The port's triangular Legendre contractions against the Pallas kernels
of the JAX package (interpret mode), and the CUDA kernels against their
plain versions on the card.

On the machine with the card run
``python -m pytest --noconftest tests/test_torch_legendre_kernels.py``
(without the JAX package's conftest); where jax is not installed the
Pallas comparisons skip."""

import numpy as np
import pytest
import torch

from torch_parity import cuda_device, n, t64, tri_table  # noqa: F401
from gibbssampler_tpu_torch.sht import legendre_kernels as lk


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("L,nr,C,tile", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, L, nr, C, tile, dtype, rtol):
    """Kernel against plain einsum on the card; max |err| <= rtol max |ref|
    (the sums run in another order: float32 keeps ~7 digits)."""
    lam, x, g = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
                 for a in _inputs(L, nr, C, integer=False))
    lk.reset_launch_counts()
    for kern, plain, b, shape in ((lk.legendre_synth_tri,
                                   lk.legendre_synth_tri_plain, x,
                                   (L, nr, C)),
                                  (lk.legendre_adj_tri,
                                   lk.legendre_adj_tri_plain, g,
                                   (L, C, L))):
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
    with pytest.raises(TypeError):
        lk.legendre_synth_tri(lam.to(torch.bfloat16), x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        lk.legendre_adj_tri(lam, g.transpose(0, 1).contiguous()
                            .transpose(0, 1))
