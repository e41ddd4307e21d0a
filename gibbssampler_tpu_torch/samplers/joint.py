"""Joint correlated-field sampling with per-ell k x k covariance blocks
(PyTorch counterpart of ``gibbssampler_tpu.samplers.joint``):

- ``exact_joint_cr``: the full-sky exact draw of k correlated fields per
  slot, posterior precision P_l = C_l^-1 + diag_f(g_f b_l^2);
- ``cg_joint_cr``: the masked-sky draw, block-preconditioned CG on
  Q = C^-1 + B A^T N^-1 A B;
- ``synfast_joint``: correlated fields from C_ell blocks.

Fields are ordered (T, E[, B]); a spin-3 ``SkyModel`` takes T through the
spin-0 transform and (E, B) through the spin-2 one.  States are (..., k,
nstate) grid-packed tensors whose leading axes are chains, and C_ell
blocks (..., lmax+1, k, k).

Every k x k matrix of these draws depends on the slot only through its
degree l, so the factorizations run once per (chain, l), not once per
slot, and are applied to a state through the l axis of the grid-packed
layout (``_apply_blocks``): no per-slot matrix is ever formed.  The
factorizations use ``cholesky_ex`` / ``inv_ex`` (no host sync on their
status), and a factor that fails comes out as NaN, as the JAX package's
``jnp.linalg.cholesky`` returns it.

Gaussian variates are injectable (``xi``, ``om0``, ``om1``), each
(..., k, nstate) or the pixel shape, so that a test can feed both packages
the same numbers; otherwise they come from ``gen``.
"""

from __future__ import annotations

import math

import torch

from ..diagnostics import trace
from ..harmonics.gridstate import ell_mask_state, state_masks
from ..harmonics.spectra import device_constant
from ..ops.cg import cg_solve
from .cr import CRInfo

__all__ = ["expand_cl_blocks", "blocks_to_dl", "exact_joint_cr",
           "joint_block_ops", "cg_joint_cr", "synfast_joint"]


def expand_cl_blocks(cl_blocks: torch.Tensor, lmax: int) -> torch.Tensor:
    """(..., lmax+1, k, k) C_ell blocks -> (..., nstate, k, k) per-slot
    covariance (invalid slots get zero)."""
    L = lmax + 1
    k = cl_blocks.shape[-1]
    valid = device_constant(("valid", lmax), lambda: state_masks(lmax).valid,
                            cl_blocks.dtype, cl_blocks.device)
    out = cl_blocks[..., None, None, :, :, :] * valid[..., None, None]
    return out.reshape(cl_blocks.shape[:-3] + (2 * L * L, k, k))


def blocks_to_dl(cl_blocks: torch.Tensor, lmax: int) -> torch.Tensor:
    """C_ell blocks -> D_ell blocks (l(l+1)/2pi scaling elementwise)."""
    ell = torch.arange(lmax + 1, dtype=cl_blocks.dtype,
                       device=cl_blocks.device)
    return cl_blocks * (ell * (ell + 1.0) / (2.0 * math.pi))[:, None, None]


def _active(lmax: int, dtype, device) -> torch.Tensor:
    """(nstate,) 1 on the valid slots with l >= 2."""
    return device_constant(("ell_mask", lmax, 2),
                           lambda: ell_mask_state(lmax, lmin=2), dtype, device)


def _act_l(lmax: int, device) -> torch.Tensor:
    """(lmax+1, 1, 1) True for l >= 2: the degrees whose blocks are used."""
    return (torch.arange(lmax + 1, device=device) >= 2)[:, None, None]


def _eye(k, like) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _chol(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization fails."""
    c, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], c, math.nan)


def _inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse, NaN where the matrix is singular."""
    c, info = torch.linalg.inv_ex(a)
    return torch.where((info == 0)[..., None, None], c, math.nan)


def _apply_blocks(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[..., i, slot] = sum_j blocks[..., l(slot), i, j] x[..., j, slot]:
    per-ell (..., L, k, k) matrices applied to a (..., k, nstate)
    grid-packed state through its l axis."""
    L = blocks.shape[-3]
    batch = torch.broadcast_shapes(blocks.shape[:-3], x.shape[:-2])
    g = x.reshape(x.shape[:-1] + (2, L, L)).expand(batch + x.shape[-2:-1]
                                                   + (2, L, L))
    out = torch.einsum("...lij,...jpml->...ipml",
                       blocks.expand(batch + blocks.shape[-3:]), g)
    return out.reshape(batch + x.shape[-2:])


def _noise_diag_l(model, dtype) -> torch.Tensor:
    """(k, lmax+1) per-ell g_f b_l^2, the diagonal of B A^T N^-1 A B on the
    full sky (``SkyModel.harmonic_noise_diag`` before its slot
    expansion)."""
    g = (model.noise.tau_max / model.noise.omega).to(dtype)
    return g[:, None] * (model.bl.to(dtype) ** 2)[None, :]


def _slot_chol_sample(P, b, active, xi=None, gen=None):
    """Draw x ~ N(P^-1 b, P^-1) in every slot.

    P: (..., L, k, k) per-ell precision (the degrees l < 2 take the
    identity); b: (..., k, nstate); active: (nstate,) 0/1; xi: optional
    (..., k, nstate) N(0, 1).  With P = R R^T (R lower), x = R^-T (R^-1 b
    + xi).  Inactive slots get x = 0."""
    lmax = P.shape[-3] - 1
    k = P.shape[-1]
    R = _chol(torch.where(_act_l(lmax, P.device), P, _eye(k, P)))
    Rinv = torch.linalg.solve_triangular(
        R, _eye(k, P).expand(R.shape), upper=False)
    if xi is None:
        shape = torch.broadcast_shapes(P.shape[:-3], b.shape[:-2]) \
            + b.shape[-2:]
        xi = torch.randn(shape, generator=gen, dtype=b.dtype, device=b.device)
    x = _apply_blocks(Rinv.transpose(-1, -2), _apply_blocks(Rinv, b) + xi)
    return x * active


@trace.traced("cr.exact_joint")
def exact_joint_cr(model, cl_blocks, bt_ninv_d, xi=None, gen=None):
    """Full-sky exact joint CR draw.

    model: a spin-3 SkyModel (k = 3); cl_blocks: (..., lmax+1, k, k) prior
    C_ell blocks (zero below l = 2); bt_ninv_d: (k, nstate) data term
    B A^T N^-1 d.  Per slot of degree l the posterior over the k-vector is
    N(P_l^-1 b, P_l^-1) with P_l = C_l^-1 + diag_f(g_f b_l^2).  ``xi``:
    optional (..., k, nstate) N(0, 1) fluctuation variates."""
    lmax = model.lmax
    k = bt_ninv_d.shape[-2]
    dt, dev = bt_ninv_d.dtype, bt_ninv_d.device
    cl = cl_blocks.to(dt)
    cinv = _inv(torch.where(_act_l(lmax, dev), cl, _eye(k, cl)))
    P = cinv + torch.diag_embed(_noise_diag_l(model, dt).T)
    s = _slot_chol_sample(P, bt_ninv_d, _active(lmax, dt, dev), xi=xi,
                          gen=gen)
    batch = s.shape[:-2]
    return s, CRInfo(accept=s.new_ones(batch), extra=s.new_zeros(batch))


def joint_block_ops(model, cl_blocks, fsky_scale: bool = True):
    """The per-ell k x k operators of the masked joint CR solve.

    Returns (apply_cinv, apply_sqrt_cinv, apply_precond, active): C^-1, a
    root M with M M^T = C^-1 (for the fluctuation RHS), the block-diagonal
    preconditioner (C^-1 + diag_f(f_sky g_f b_l^2))^-1, each a map of
    (..., k, nstate) states that is 0 off the active slots, and the
    (nstate,) active mask.  The factorizations happen here, once per
    solve."""
    lmax = model.lmax
    dt, dev = cl_blocks.dtype, cl_blocks.device
    k = cl_blocks.shape[-1]
    act = _act_l(lmax, dev)
    eye = _eye(k, cl_blocks)
    cinv = torch.where(act, _inv(torch.where(act, cl_blocks, eye)), 0.0)
    M = torch.where(act, _chol(torch.where(act, cinv, eye)), 0.0)
    hd = _noise_diag_l(model, dt)
    if fsky_scale:
        hd = hd * model.noise.f_sky[:, None].to(dt)
    pinv = torch.where(act, _inv(torch.where(
        act, cinv + torch.diag_embed(hd.T), eye)), 0.0)
    active = _active(lmax, dt, dev)

    def mv(blocks):
        return lambda x: _apply_blocks(blocks, x) * active

    return mv(cinv), mv(M), mv(pinv), active


@trace.traced("cr.cg_joint")
def cg_joint_cr(model, cl_blocks, bt_ninv_d, tol=1e-6, maxiter=4000,
                om0=None, om1=None, gen=None):
    """Masked-sky joint CR draw by block-preconditioned CG on
    Q s = C^-1 s + B A^T N^-1 A B s, per-slot k x k C.  ``model.qn_apply``
    takes the cut-ring complement transforms when the model carries the
    cut decomposition.

    Perturbation-optimization RHS: b = B A^T N^-1 d + M om0 + B A^T
    N^-1/2 om1 with M M^T = C^-1, so the exact solve is a draw from
    N(Q^-1 b_mean, Q^-1).  om0: (..., k, nstate) and om1: (...,
    *model.noise.tau.shape) N(0, 1), drawn from ``gen`` in that order when
    not given.  Each chain stops at its own tolerance (``cg_solve``);
    ``CRInfo.extra`` holds its iterations."""
    dt = bt_ninv_d.dtype
    cl = cl_blocks.to(dt)
    apply_cinv, apply_sqrt_cinv, apply_pinv, active = joint_block_ops(
        model, cl)
    batch = cl.shape[:-3]
    if om0 is None:
        om0 = torch.randn(batch + tuple(bt_ninv_d.shape[-2:]), generator=gen,
                          dtype=dt, device=bt_ninv_d.device)
    if om1 is None:
        om1 = torch.randn(batch + tuple(model.noise.tau.shape), generator=gen,
                          dtype=dt, device=bt_ninv_d.device)
    b = bt_ninv_d + apply_sqrt_cinv(om0)
    b = b + model.project_data(torch.sqrt(model.noise.inv_noise).to(dt) * om1)
    b = b * active

    def q_apply(x):
        x = x * active
        return (apply_cinv(x) + model.qn_apply(x)) * active

    x, info = cg_solve(q_apply, b, precond=apply_pinv, tol=tol,
                       maxiter=maxiter, ndim_sys=2)
    return x * active, CRInfo(accept=x.new_ones(info.iterations.shape),
                              extra=info.iterations.to(dt))


def synfast_joint(cl_blocks, lmax: int, dtype=torch.float32, device="cuda",
                  xi=None, gen=None):
    """Correlated grid-packed alm fields from C_ell blocks (..., lmax+1, k,
    k): s = R_l xi in every slot, R_l the lower Cholesky factor of C_l.
    Returns (..., k, nstate), zero below l = 2.  ``xi``: optional (..., k,
    nstate) N(0, 1)."""
    cl = torch.as_tensor(cl_blocks, dtype=dtype, device=device)
    k = cl.shape[-1]
    R = _chol(torch.where(_act_l(lmax, cl.device), cl, _eye(k, cl)))
    if xi is None:
        L = lmax + 1
        xi = torch.randn(cl.shape[:-3] + (k, 2 * L * L), generator=gen,
                         dtype=dtype, device=cl.device)
    return _apply_blocks(R, xi.to(dtype)) * _active(lmax, dtype, cl.device)
