"""Batched preconditioned conjugate gradients (PyTorch counterpart of
``gibbssampler_tpu.ops.cg``): the masked constrained-realization solver,
with a plain path and a mixed-precision monotone restarted path.

The right-hand side ``b`` is (..., *system_shape): the leading axes are
independent systems (the chains), the trailing ``ndim_sys`` axes form one
system.  Every chain gets the result it would get alone, as the JAX
package's schemes get it by running ``cg_solve`` under ``jax.vmap``: each
chain stops iterating, with its whole carry (iteration count included)
frozen, once its own residual passes the tolerance or it has run
``maxiter`` iterations.  The operator is applied to the whole batch each
iteration and the frozen chains' updates are discarded (``torch.where``),
so shapes stay fixed.

The loop is a Python loop that reads, on the host, whether any chain is
still active after every iteration.  One iteration costs two transforms
(milliseconds at lmax 512), against one launch latency for the read, and
the loop then makes exactly max-over-chains iterations, so an apply's
kernel launches count max(iterations) times.  Frozen chains never change,
so a sparser cadence would move no result, only add whole-batch applies.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..diagnostics import trace

__all__ = ["cg_solve", "CGInfo"]


class CGInfo(NamedTuple):
    iterations: torch.Tensor     # (...,) int64: iterations of each chain
    residual_norm: torch.Tensor  # (...,) final ||b - Q x|| per chain
    converged: torch.Tensor      # (...,) bool per chain


def _batch_dot(a, b, ndim_sys: int):
    """Sum over the trailing ndim_sys axes (the per-system axes)."""
    return (a * b).sum(dim=tuple(range(-ndim_sys, 0)))


def cg_solve(operator: Callable[[torch.Tensor], torch.Tensor],
             b: torch.Tensor, x0: torch.Tensor | None = None,
             precond_diag: torch.Tensor | None = None, tol: float = 1e-6,
             maxiter: int = 4000, ndim_sys: int = 2,
             precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
             apply_dtype=None,
             operator_hi: Callable[[torch.Tensor], torch.Tensor] | None = None,
             replace_every: int = 10):
    """Solve operator(x) = b for SPD ``operator``, per chain.

    b : (..., *system_shape) right-hand sides; leading axes are chains
    x0 : initial guess (0 if None)
    precond_diag : elementwise M^-1, broadcastable to b; ``precond`` (a
        general SPD callable M^-1 v) overrides it
    tol : relative tolerance on ||r|| / ||b|| per chain
    maxiter : iteration cap per chain
    ndim_sys : how many trailing axes form one linear system
    apply_dtype : run ``operator`` at this lower dtype (b cast in, the
        result cast back) while x, r, p and every recurrence scalar stay at
        ``b.dtype``: the mixed-precision path below.
    operator_hi : full-precision operator used for the true residuals of
        the mixed path (default: the low-precision apply)
    replace_every : on the mixed path, recompute the true residual and
        restart the search direction every this many iterations.

    The mixed path is the JAX package's monotone restarted CG with its
    three safeguards: a step of non-positive curvature (<p, Qp> or <r, z>
    <= 0) is skipped and forces a replacement; a residual grown 4x past
    its value at the last replacement forces one; and every replacement
    restarts from the best (x, true residual) pair seen so far.  Each
    decision is per chain.  At the end the port compares the current
    iterate's TRUE residual with the best point's (the JAX package
    compares its recurrence residual there, ``ops/cg.py:212``), which costs
    one more full-precision apply.
    """
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    if precond is not None:
        minv = precond
    elif precond_diag is not None:
        minv = lambda v: precond_diag * v
    else:
        minv = lambda v: v

    hi = b.dtype
    lo = None if apply_dtype is None or apply_dtype == hi else apply_dtype

    def apply_op(v):
        if lo is None:
            return operator(v)
        return operator(v.to(lo)).to(hi)

    rep_op = operator_hi if operator_hi is not None else apply_op
    nb = (...,) + (None,) * ndim_sys
    dot = lambda u, v: _batch_dot(u, v, ndim_sys)
    norm = lambda u: torch.sqrt(dot(u, u))

    # Q 0 = 0 exactly, so a zero start needs no apply
    r = b.clone() if x0 is None else b - rep_op(x)
    z = minv(r)
    p = z
    rz = dot(r, z)
    bnorm = norm(b)
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    i = torch.zeros(bnorm.shape, dtype=torch.int64, device=b.device)
    thresh = tol * bnorm

    def still(i, rnorm):
        return (i < maxiter) & (rnorm > thresh)

    if lo is None or not replace_every:
        active = still(i, norm(r))
        while trace.host_bool("cg.iter", active.any()):
            qp = apply_op(p)
            denom = dot(p, qp)
            alpha = rz / torch.where(denom == 0, 1.0, denom)
            x_n = x + alpha[nb] * p
            r_n = r - alpha[nb] * qp
            z = minv(r_n)
            rz_n = dot(r_n, z)
            beta = rz_n / torch.where(rz == 0, 1.0, rz)
            p_n = z + beta[nb] * p
            a = active[nb]
            x, r, p = (torch.where(a, x_n, x), torch.where(a, r_n, r),
                       torch.where(a, p_n, p))
            rz = torch.where(active, rz_n, rz)
            i = i + active.to(i.dtype)
            active = still(i, norm(r))
        rnorm = norm(r)
        return x, CGInfo(iterations=i, residual_norm=rnorm,
                         converged=rnorm <= thresh)

    # ---- mixed-precision path: monotone restarted CG ------------------
    rref = norm(r)
    xb, rb, rbn = x, r, rref
    active = still(i, rref)
    while trace.host_bool("cg.iter", active.any()):
        qp = apply_op(p)
        denom = dot(p, qp)
        bad = (denom <= 0) | (rz <= 0)
        alpha = torch.where(bad, 0.0,
                            rz / torch.where(denom == 0, 1.0, denom))
        x_n = x + alpha[nb] * p
        r_n = r - alpha[nb] * qp
        do_repl = (((i + 1) % replace_every == 0) | (norm(r_n) > 4.0 * rref)
                   | bad) & active
        # no replacement: the plain recurrence
        z = minv(r_n)
        rz_n = dot(r_n, z)
        beta = rz_n / torch.where(rz == 0, 1.0, rz)
        p_n = z + beta[nb] * p
        rref_n = rref
        if trace.host_bool("cg.replace", do_repl.any()):
            # the true residual at the new iterate; restart from the best
            # (x, true residual) pair of the chains that replace
            rr = b - rep_op(x_n)
            rn = norm(rr)
            better = (rn < rbn) & do_repl
            xb = torch.where(better[nb], x_n, xb)
            rb = torch.where(better[nb], rr, rb)
            rbn = torch.where(do_repl, torch.minimum(rn, rbn), rbn)
            zz = minv(rb)
            rz_r = dot(rb, zz)
            rp = do_repl[nb]
            x_n = torch.where(rp, xb, x_n)
            r_n = torch.where(rp, rb, r_n)
            p_n = torch.where(rp, zz, p_n)
            rz_n = torch.where(do_repl, rz_r, rz_n)
            rref_n = torch.where(do_repl, rbn, rref)
        a = active[nb]
        x, r, p = (torch.where(a, x_n, x), torch.where(a, r_n, r),
                   torch.where(a, p_n, p))
        rz = torch.where(active, rz_n, rz)
        rref = torch.where(active, rref_n, rref)
        i = i + active.to(i.dtype)
        active = still(i, norm(r))
    # the better of (current iterate, best replacement point), both by
    # their true residuals
    rn_cur = norm(b - rep_op(x))
    take_cur = rn_cur <= rbn
    x = torch.where(take_cur[nb], x, xb)
    rnorm = torch.minimum(rn_cur, rbn)
    return x, CGInfo(iterations=i, residual_norm=rnorm,
                     converged=rnorm <= thresh)
