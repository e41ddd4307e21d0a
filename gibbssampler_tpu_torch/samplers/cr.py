"""Constrained-realization (CR) conditional samplers (PyTorch counterpart of
``gibbssampler_tpu.samplers.cr``: the exact draw, the CG family (plain CG,
RJPO, pCN) and the auxiliary-variable family (aux-Gibbs, overrelaxation,
MALA / ULA, aux-Gibbs + MALA)).

Draws s | C_ell, d  ~  N(Q^-1 b, Q^-1),   Q = C^-1 + B A^T N^-1 A B.

State ``s_old`` and ``var_cls`` are (..., nfields, nstate) grid-packed
tensors whose leading axes are chains; every log-target, log-ratio, accept
and CG iteration count is one value per chain.  Gaussian variates come from
a pre-drawn noise pool ``{kind: (nchains, K, *shape)}`` when one is given
(the schemes draw one per iteration, ``schemes.gibbs.GibbsScheme.
draw_noise_pool``) and otherwise from the ``gen`` generator; the MH accept
uniform of MALA, RJPO and pCN may be injected as ``u`` (one per chain), so
that a test can feed both packages the same numbers.  Slots with var_cls =
0 stay exactly 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..diagnostics import trace
from ..harmonics.gridstate import expand_cl_state
from ..ops.cg import cg_solve
from ..ops.model import SkyModel, sum_last_f64

__all__ = ["noise_pool_spec", "CRInfo", "exact_cr", "fluctuated_rhs",
           "cr_precond", "cg_cr", "rjpo_cr", "aux_gibbs_cr", "overrelax_cr",
           "mala_cr", "mala_log_ratio", "aux_then_mala_cr", "pcn_cr",
           "pcn_log_ratio"]

# mu = max(N^-1) + eps for the aux field without the cut decomposition
# (the reference's ConstrainedRealization.py:44)
_AUX_EPS = 1e-7


def noise_pool_spec(method: str, opts: dict) -> dict:
    """Number of pre-drawn N(0,1) fields each CR method consumes per step,
    by kind: "state" (nfields, nstate), "aux" (the auxiliary pixel field:
    the cut rows under the cut decomposition, the full grid otherwise),
    "sp" (the auxiliary field's hole-point block; drawn only for models
    with the sparse split) and "pix" (the full pixel grid,
    ``model.noise.tau.shape``)."""
    n_g = int(opts.get("n_gibbs", 1))
    return {
        "exact": {"state": 1},
        "cg": {"state": 1, "pix": 1},
        "rjpo": {"state": 1, "pix": 1},
        "aux_gibbs": {"state": n_g, "aux": n_g, "sp": n_g},
        "overrelax": {"state": 2 * n_g, "aux": 1 + n_g, "sp": 1 + n_g},
        "mala": {"state": 1},
        "ula": {"state": 1},
        "aux_mala": {"state": n_g + 1, "aux": n_g, "sp": n_g},
        "pcn": {"state": 1},
    }[method]


class _Pool:
    """Cursor over a pre-drawn noise dict {kind: (nchains, K, *shape)}."""

    def __init__(self, noise):
        self.noise = noise
        self._i = {}

    def take(self, kind):
        """The next field of ``kind``: (nchains, *shape)."""
        j = self._i.get(kind, 0)
        self._i[kind] = j + 1
        return self.noise[kind][:, j]


def _as_pool(noise):
    if isinstance(noise, _Pool):
        return noise
    return _Pool(noise) if noise else None


def _safe_inv(v):
    return torch.where(v > 0, 1.0 / torch.where(v > 0, v, 1.0), 0.0)


def _active(var_cls):
    return (var_cls > 0).to(var_cls.dtype)


def _normal(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


class CRInfo(NamedTuple):
    accept: torch.Tensor   # (nchains,) 1.0 where the move was accepted
    extra: torch.Tensor    # (nchains,) algorithm-specific (CG iterations,
                           # MH log-ratio)


def _batch_shape(var_cls, s_old=None):
    shape = var_cls.shape if s_old is None else torch.broadcast_shapes(
        var_cls.shape, s_old.shape)
    return tuple(shape[:-2])


@trace.traced("cr.exact")
def exact_cr(model: SkyModel, var_cls, bt_ninv_d, noise=None, gen=None):
    """Full-sky exact draw: Sigma = (C^-1 + g b_l^2)^-1 elementwise."""
    inv_cvar = _safe_inv(var_cls)
    hdiag = model.harmonic_noise_diag().to(var_cls.dtype)
    sigma = _safe_inv(inv_cvar + hdiag) * _active(var_cls)
    pool = _as_pool(noise)
    xi = pool.take("state") if pool else _normal(gen, var_cls.shape, var_cls)
    s = sigma * bt_ninv_d + torch.sqrt(sigma) * xi
    batch = _batch_shape(var_cls)
    return s, CRInfo(accept=var_cls.new_ones(batch),
                     extra=var_cls.new_zeros(batch))


def fluctuated_rhs(model: SkyModel, var_cls, bt_ninv_d, noise=None,
                   gen=None):
    """b = B A^T N^-1 d + C^-1/2 om0 + B A^T N^-1/2 om1: the random RHS whose
    exact solve is a draw from N(Q^-1 b_mean, Q^-1) (perturbation-
    optimization, the plain CG and RJPO steps).  om0 is a "state" field,
    om1 a "pix" field on the full grid, whose adjoint runs over every ring
    even on a cut model."""
    pool = _as_pool(noise)
    inv_cvar = _safe_inv(var_cls)
    if pool:
        om0, om1 = pool.take("state"), pool.take("pix")
    else:
        om0 = _normal(gen, var_cls.shape, var_cls)
        om1 = _normal(gen, _batch_shape(var_cls)
                      + tuple(model.noise.tau.shape), var_cls)
    b = bt_ninv_d + torch.sqrt(inv_cvar) * om0
    b = b + model.project_data(torch.sqrt(model.noise.inv_noise) * om1)
    return b * _active(var_cls)


def cr_precond(model: SkyModel, var_cls, fsky_scale=True):
    """Diagonal preconditioner 1/(C^-1 + f_sky g b_l^2) (qcinv's diag_cl
    analogue)."""
    inv_cvar = _safe_inv(var_cls)
    hdiag = model.harmonic_noise_diag().to(var_cls.dtype)
    if fsky_scale:
        hdiag = hdiag * model.noise.f_sky[:, None].to(var_cls.dtype)
    return _safe_inv(inv_cvar + hdiag) * _active(var_cls)


def _q_op(model: SkyModel, inv_cvar):
    """The CG operator: the cut-ring complement form when attached, else
    the plain masked apply."""
    if model.has_cut:
        return lambda x: model.q_apply_cut(x, inv_cvar)
    return lambda x: model.q_apply(x, inv_cvar)


@trace.traced("cr.cg")
def cg_cr(model: SkyModel, var_cls, bt_ninv_d, s_old=None, tol=1e-6,
          maxiter=4000, noise=None, gen=None):
    """Perturbation-optimization CG draw, seeded at zero (``s_old`` is
    unused, as in the JAX package's signature); treated as exact.
    ``CRInfo.extra`` holds each chain's CG iterations."""
    inv_cvar = _safe_inv(var_cls)
    b = fluctuated_rhs(model, var_cls, bt_ninv_d, noise=noise, gen=gen)
    x, info = cg_solve(_q_op(model, inv_cvar), b,
                       precond_diag=cr_precond(model, var_cls), tol=tol,
                       maxiter=maxiter, ndim_sys=2)
    x = x * _active(var_cls)
    return x, CRInfo(accept=x.new_ones(info.iterations.shape),
                     extra=info.iterations.to(x.dtype))


@trace.traced("cr.rjpo")
def rjpo_cr(model: SkyModel, var_cls, bt_ninv_d, s_old, tol=1e-5,
            maxiter=4000, noise=None, gen=None, u=None):
    """RJPO: solve the fluctuated system approximately and Metropolis-
    correct with its residual,

        log alpha = -<r, s_old - s_hat>,   r = b - Q s_hat.

    The solver starts at MINUS the current state, as the reference does.
    The sign matters: CG leaves its final residual orthogonal to the
    Krylov span, in which s_hat - x0 lies, so log alpha = <r, x0 - s_old>
    vanishes identically for x0 = +s_old (every truncated solve would be
    accepted uncorrected); with x0 = -s_old it is <r, -2 s_old>, a real
    measure of the unconverged residual.  The log-ratio is accumulated in
    float64 (``sum_last_f64``); ``u``: optional (nchains,) accept
    uniforms."""
    inv_cvar = _safe_inv(var_cls)
    act = _active(var_cls)
    b = fluctuated_rhs(model, var_cls, bt_ninv_d, noise=noise, gen=gen)
    op = _q_op(model, inv_cvar)
    s_hat, _ = cg_solve(op, b, x0=-s_old * act,
                        precond_diag=cr_precond(model, var_cls), tol=tol,
                        maxiter=maxiter, ndim_sys=2)
    s_hat = s_hat * act
    r = b - op(s_hat)
    log_ratio = (-sum_last_f64(r * (s_old - s_hat), 2)).to(s_hat.dtype)
    if u is None:
        u = torch.rand(log_ratio.shape, generator=gen, dtype=s_hat.dtype,
                       device=s_hat.device)
    acc = torch.log(u) < log_ratio
    s_new = torch.where(acc[..., None, None], s_hat, s_old)
    return s_new, CRInfo(accept=acc.to(s_hat.dtype), extra=log_ratio)


def _aux_ops(model: SkyModel, var_cls):
    """The pixel gap operator (mu - N^-1), the harmonic posterior variance
    Sigma = (C^-1 + mu_bar/omega b_l^2)^-1, and the forward/project maps of
    the two aux conditionals.  The gap, the output of ``fwd`` and the input
    of ``proj`` are tuples of parts, each part with its own auxiliary
    field.

    With the cut decomposition attached mu is exactly max(N^-1): the gap
    vanishes off the masked rings, the auxiliary field lives on the cut
    rings only and both conditionals run through cut-ring transforms.
    With the sparse split the gap has two parts, w_floor and w_sp, with
    independent auxiliary fields (the product of two augmentations targets
    the same posterior), through the fused ``synthesis_cut_sp`` /
    ``adjoint_cut_sp`` pair."""
    noise = model.noise
    dt = var_cls.dtype
    inv_cvar = _safe_inv(var_cls)
    bl2 = expand_cl_state(model.bl.to(dt) ** 2, model.lmax)
    if model.has_sparse:
        gap = (model.w_cut.to(dt), model.w_sp.to(dt))
        mu_bar = noise.tau_max.to(dt)
        fwd = lambda s: model.synthesis_cut_sp(model.beam(s))
        proj = lambda v: model.beam(model.adjoint_cut_sp(*v))
    elif model.has_cut:
        gap = (model.w_cut.to(dt),)
        mu_bar = noise.tau_max.to(dt)
        fwd = lambda s: (model.synthesis_cut(model.beam(s)),)
        proj = lambda v: model.beam(model.adjoint_synthesis_cut(v[0]))
    else:
        mu_bar = noise.tau_max.to(dt) + _AUX_EPS     # (nfields,)
        gap = ((noise.q_map * (noise.field_bcast(mu_bar)
                               - noise.tau)).to(dt).clamp_min(0.0),)
        fwd = lambda s: (model.forward(s),)
        proj = lambda v: model.project_data(v[0])
    hdiag = (mu_bar[:, None] / noise.omega) * bl2[None, :]
    sigma = _safe_inv(inv_cvar + hdiag) * _active(var_cls)
    return gap, sigma, fwd, proj


@trace.traced("cr.aux")
def aux_gibbs_cr(model: SkyModel, var_cls, bt_ninv_d, s_old,
                 n_gibbs: int = 1, noise=None, gen=None):
    """Auxiliary-variable Gibbs: augment with the pixel field
    v | s ~ N((mu - N^-1) A B s, mu - N^-1); then s | v, d is diagonal in
    harmonic space.  ``n_gibbs`` sweeps per call; per sweep the variates
    are taken in the order aux, sp (split models), state."""
    gap, sigma, fwd, proj = _aux_ops(model, var_cls)
    pool = _as_pool(noise)
    s = s_old * _active(var_cls)
    batch = _batch_shape(var_cls, s_old)
    for _ in range(n_gibbs):
        if pool:
            xi_v = [pool.take(k) for k in ("aux", "sp")[:len(gap)]]
            xi_s = pool.take("state")
        else:
            xi_v = [_normal(gen, batch + tuple(g.shape), s) for g in gap]
            xi_s = _normal(gen, s.shape, s)
        v = tuple(g * f + torch.sqrt(g) * x
                  for g, f, x in zip(gap, fwd(s), xi_v))
        s = sigma * (proj(v) + bt_ninv_d) + torch.sqrt(sigma) * xi_s
    return s, CRInfo(accept=s.new_ones(batch), extra=s.new_zeros(batch))


@trace.traced("cr.overrelax")
def overrelax_cr(model: SkyModel, var_cls, bt_ninv_d, s_old,
                 alpha: float = -0.995, n_gibbs: int = 1, noise=None,
                 gen=None):
    """Overrelaxed auxiliary sampler: one plain v | s draw to define the
    auxiliary chain state, then ``n_gibbs`` overrelaxed sweeps of
    (s | v, v | s, s | v) with
    x <- m + alpha (x - m) + sqrt(1 - alpha^2) sqrt(Sigma) xi.
    Variates in the JAX package's order: the initial aux (and sp), then per
    sweep state, aux (and sp), state."""
    gap, sigma, fwd, proj = _aux_ops(model, var_cls)
    pool = _as_pool(noise)
    s = s_old * _active(var_cls)
    batch = _batch_shape(var_cls, s_old)
    sq = torch.sqrt(torch.tensor(1.0 - alpha * alpha, dtype=s.dtype))
    sqrt_sigma = torch.sqrt(sigma)

    def xi_state():
        return pool.take("state") if pool else _normal(gen, s.shape, s)

    def xi_aux():
        if pool:
            return [pool.take(k) for k in ("aux", "sp")[:len(gap)]]
        return [_normal(gen, batch + tuple(g.shape), s) for g in gap]

    v = tuple(g * f + torch.sqrt(g) * x
              for g, f, x in zip(gap, fwd(s), xi_aux()))
    for _ in range(n_gibbs):
        m = sigma * (proj(v) + bt_ninv_d)
        s = m + alpha * (s - m) + sq * sqrt_sigma * xi_state()
        v = tuple(g * f + alpha * (vv - g * f) + sq * torch.sqrt(g) * x
                  for g, f, vv, x in zip(gap, fwd(s), v, xi_aux()))
        m = sigma * (proj(v) + bt_ninv_d)
        s = m + alpha * (s - m) + sq * sqrt_sigma * xi_state()
    return s, CRInfo(accept=s.new_ones(batch), extra=s.new_zeros(batch))


class _LikeOps(NamedTuple):
    """The data log-likelihood of a state x through its forward maps
    (``_like_ops``)."""
    fwd: object              # x -> the forward maps of x
    ll: object               # (x, maps) -> the log-likelihood, as a total
    dll: object              # (x, maps, dx, dmaps) -> its exact change


def _like_ops(model: SkyModel) -> _LikeOps:
    """With the cut decomposition the maps are the cut rows' (and the hole
    points'), through cut-ring transforms; otherwise the full grid's."""
    if model.has_cut:
        def fwd(x):
            """(A_cut B x, A_sp B x): one cut synthesis (fused with the
            point set's under the sparse split)."""
            return model.synthesis_cut_sp(model.beam(x))

        def ll(x, maps):
            return model.data_loglike_cut(model.beam(x), *maps)

        def dll(x, maps, dx, dmaps):
            return model.data_loglike_cut_delta(model.beam(x), *maps,
                                                model.beam(dx), *dmaps)
        return _LikeOps(fwd, ll, dll)

    inv_noise = model.noise.inv_noise
    # the field and pixel axes of the full grid's maps
    pix_axes = tuple(range(-(model.map_ndim + 1), 0))

    def fwd(x):
        return (model.forward(x),)

    def ll(x, maps):
        resid = model.d - maps[0]
        return -0.5 * (inv_noise * resid * resid).sum(dim=pix_axes)

    def dll(x, maps, dx, dmaps):
        """-1/2 sum N^-1 [(r - A B dx)^2 - r^2] = -sum N^-1 A B dx
        (A B dx / 2 + A B x - d), formed term by term."""
        adx = dmaps[0]
        return -sum_last_f64(inv_noise * adx * torch.add(
            maps[0], adx, alpha=0.5).sub_(model.d),
            model.map_ndim + 1).to(x.dtype)
    return _LikeOps(fwd, ll, dll)


class _MalaOps(NamedTuple):
    """The pieces of the preconditioned MALA step (``_mala_ops``)."""
    inv_cvar: torch.Tensor
    sigma: torch.Tensor      # the proposal scale: full-sky posterior diagonal
    act: torch.Tensor        # 1 on the active slots
    fwd: object              # x -> the forward maps of x
    grad: object             # (x, maps) -> the log-target's gradient
    ll: object               # (x, maps) -> the log-likelihood, as a total
    dll: object              # (x, maps, dx, dmaps) -> its exact change


def _mala_ops(model: SkyModel, var_cls, bt_ninv_d) -> _MalaOps:
    """The MALA step's pieces for ``model`` (maps as in ``_like_ops``)."""
    inv_cvar = _safe_inv(var_cls)
    hdiag = model.harmonic_noise_diag().to(var_cls.dtype)
    act = _active(var_cls)
    sigma = _safe_inv(inv_cvar + hdiag) * act
    like = _like_ops(model)

    if model.has_cut:
        def grad(x, maps):
            """one cut adjoint (fused with the point set's)."""
            au_cut, au_sp = maps
            corr = model.adjoint_cut_sp(model.w_cut * au_cut,
                                        None if au_sp is None
                                        else model.w_sp * au_sp)
            qs = hdiag * x - model.beam(corr)
            return (-inv_cvar * x - qs + bt_ninv_d) * act
    else:
        def grad(x, maps):
            qs = model.project_data(model.noise.inv_noise * maps[0])
            return (-inv_cvar * x - qs + bt_ninv_d) * act

    return _MalaOps(inv_cvar, sigma, act, like.fwd, grad, like.ll, like.dll)


def _mala_log_ratio(ops: _MalaOps, tau, s, maps_s, g_s, s_prop):
    """The MH log-ratio of the MALA move s -> s_prop, every difference
    formed term by term before its reduction (``sum_last_f64``): the
    log-target's change from one synthesis of the move (the proposal's maps
    are the state's plus the move's), and the proposal densities' pair,

        log q(s | s') - log q(s' | s) = -1/2 sum (a^2 - b^2) / (2 tau Sigma)
            = -1/2 sum (g' + g) (ds + tau/2 Sigma (g' - g)),

    with a = s - s' - tau Sigma g', b = s' - s - tau Sigma g, ds = s' - s."""
    ds = s_prop - s
    dmaps = ops.fwd(ds)
    maps_p = tuple(None if a is None else a + b for a, b in zip(maps_s, dmaps))
    g_p = ops.grad(s_prop, maps_p)
    # the prior's change, inv_cvar ds (2 s + ds), and the proposal pair's
    terms = ops.inv_cvar * ds * torch.add(ds, s, alpha=2.0)
    terms.addcmul_(g_p + g_s, torch.addcmul(ds, ops.sigma, g_p - g_s,
                                            value=0.5 * tau))
    log_ratio = (-0.5 * sum_last_f64(terms, 2)
                 + ops.dll(s, maps_s, ds, dmaps).to(torch.float64))
    return log_ratio.to(s.dtype)


def mala_log_ratio(model: SkyModel, var_cls, bt_ninv_d, s, s_prop,
                   tau: float = 0.02, exact: bool = True):
    """The MH log-ratio of the MALA move s -> s_prop (both already zero
    off the active slots), one value per chain: the form ``mala_cr``
    accepts on, or with ``exact=False`` the JAX package's form, the
    differences of four totals (two log-targets, two proposal densities),
    the reference that the exact form's float32 rounding is measured
    against."""
    ops = _mala_ops(model, var_cls, bt_ninv_d)
    maps_s = ops.fwd(s)
    g_s = ops.grad(s, maps_s)
    if exact:
        return _mala_log_ratio(ops, tau, s, maps_s, g_s, s_prop)
    maps_p = ops.fwd(s_prop)
    g_p = ops.grad(s_prop, maps_p)
    inv_step = _safe_inv(2.0 * tau * ops.sigma)

    def logp(x, maps):
        return (-0.5 * (ops.inv_cvar * x * x).sum(dim=(-2, -1))
                + ops.ll(x, maps))

    def logq(x_to, mean):
        return -0.5 * (inv_step * (x_to - mean) ** 2).sum(dim=(-2, -1))

    return (logp(s_prop, maps_p) - logp(s, maps_s)
            + logq(s, s_prop + tau * ops.sigma * g_p)
            - logq(s_prop, s + tau * ops.sigma * g_s))


@trace.traced("cr.mala")
def mala_cr(model: SkyModel, var_cls, bt_ninv_d, s_old, tau: float = 0.02,
            accept: bool = True, noise=None, gen=None, u=None):
    """Preconditioned MALA: s' = s + tau Sigma grad + sqrt(2 tau Sigma) xi,
    Sigma = full-sky posterior diagonal, Metropolis-adjusted.  With
    ``accept=False`` it returns the unadjusted (ULA) proposal.

    Each state's forward maps are computed once and shared between the
    gradient and the log-target; the proposal's are the state's plus one
    synthesis of the move, from which the log-ratio is formed exactly
    (``_mala_log_ratio``).  With the cut decomposition both run through
    cut-ring transforms.  ``u``: optional (nchains,) accept uniforms."""
    ops = _mala_ops(model, var_cls, bt_ninv_d)
    pool = _as_pool(noise)
    s = s_old * ops.act
    batch = _batch_shape(var_cls, s_old)
    maps_s = ops.fwd(s)
    g = ops.grad(s, maps_s)
    xi = pool.take("state") if pool else _normal(gen, s.shape, s)
    s_prop = (s + tau * ops.sigma * g
              + torch.sqrt(2.0 * tau * ops.sigma) * xi)
    if not accept:
        return s_prop, CRInfo(accept=s.new_ones(batch),
                              extra=s.new_zeros(batch))
    log_ratio = _mala_log_ratio(ops, tau, s, maps_s, g, s_prop)
    if u is None:
        u = torch.rand(batch, generator=gen, dtype=s.dtype, device=s.device)
    acc = torch.log(u) < log_ratio
    s_new = torch.where(acc[..., None, None], s_prop, s)
    return s_new, CRInfo(accept=acc.to(s.dtype), extra=log_ratio)


def aux_then_mala_cr(model: SkyModel, var_cls, bt_ninv_d, s_old,
                     n_gibbs: int = 1, tau: float = 0.02, noise=None,
                     gen=None, u=None):
    """One auxiliary-Gibbs sweep followed by a MALA step (the reference's
    "Composition !" branch)."""
    pool = _as_pool(noise)
    s, _ = aux_gibbs_cr(model, var_cls, bt_ninv_d, s_old, n_gibbs=n_gibbs,
                        noise=pool, gen=gen)
    return mala_cr(model, var_cls, bt_ninv_d, s, tau=tau, noise=pool,
                   gen=gen, u=u)


def pcn_log_ratio(model: SkyModel, s, s_prop, exact: bool = True):
    """The MH log-ratio log L(s') - log L(s) of a pCN move (both states
    already zero off the active slots), one value per chain.  ``pcn_cr``
    accepts on the exact form: the state's maps and one synthesis of the
    move, every difference formed before its reduction (through
    ``SkyModel.data_loglike_cut_delta`` on a cut model, term by term on the
    full grid).  ``exact=False`` gives the JAX package's form, the
    difference of the two states' totals, the reference that the exact
    form's float32 rounding is measured against."""
    like = _like_ops(model)
    maps = like.fwd(s)
    if exact:
        ds = s_prop - s
        return like.dll(s, maps, ds, like.fwd(ds)).to(s.dtype)
    return like.ll(s_prop, like.fwd(s_prop)) - like.ll(s, maps)


@trace.traced("cr.pcn")
def pcn_cr(model: SkyModel, var_cls, bt_ninv_d, s_old, beta: float = 0.1,
           noise=None, gen=None, u=None):
    """Preconditioned Crank-Nicolson step: the prior-reversible proposal
    s' = sqrt(1 - beta^2) s + beta C^{1/2} xi, accepted on the likelihood
    ratio alone (``pcn_log_ratio``).  ``u``: optional (nchains,) accept
    uniforms."""
    act = _active(var_cls)
    s = s_old * act
    pool = _as_pool(noise)
    xi = pool.take("state") if pool else _normal(gen, s.shape, s)
    s_prop = (math.sqrt(1.0 - beta * beta) * s
              + beta * torch.sqrt(var_cls) * xi) * act
    log_ratio = pcn_log_ratio(model, s, s_prop)
    if u is None:
        u = torch.rand(log_ratio.shape, generator=gen, dtype=s.dtype,
                       device=s.device)
    acc = torch.log(u) < log_ratio
    s_new = torch.where(acc[..., None, None], s_prop, s)
    return s_new, CRInfo(accept=acc.to(s.dtype), extra=log_ratio)
