"""Power-spectrum conditional samplers (PyTorch counterpart of
``gibbssampler_tpu.samplers.cls_samplers``):

- the binned conjugate inverse-gamma draw of the centered scheme
  (``invgamma_dl``, ``centered_cls_sample``) and the joint per-ell
  inverse-Wishart draw of k x k C_ell blocks (``invwishart_cls_sample``);
- blocked Metropolis-within-Gibbs over binned D_ell with truncated-normal
  proposals on the non-centered (whitened) parametrization: the direct
  ``nc_cls_sample``, one likelihood evaluation per block, and its rank-one
  fast path ``nc_cls_sample_cut`` for cut-decomposition models, on the
  engine the JAX package picks (table domain, coefficient m domain or phi
  domain);
- the ASIS ``whiten`` / ``recenter`` transforms.

Every function takes tensors whose leading axes are chains.  Random numbers
are injectable, so that a test can feed both packages the same numbers, or
come from an explicit ``torch.Generator``:

- gamma variates of the conjugate draw come from ``standard_gamma``, a
  Marsaglia-Tsang rejection sampler on ``torch.randn`` / ``torch.rand``
  (``torch.distributions.Gamma.sample`` takes no generator);
- the MH step takes, per sweep, one U(0,1) per bin for the proposals
  (``u_prop``, (..., n_iter, nbins_total)) and one per block for the
  accept decisions (``u_acc``, (..., n_iter, nblocks)).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..harmonics.gridstate import (alm2cl_state, almxfl_state,
                                   expand_cl_state, state_masks,
                                   variance_expansion_state)
from ..harmonics.spectra import bin_sum, dl_to_cl_factor, unfold_bins
from ..ops.model import sum_last_f64
from ..sht.legendre_kernels import cast_to
from ..sht.transform import SPIN2_SINGLE_SIGNS

__all__ = ["standard_gamma", "invgamma_dl", "centered_cls_sample",
           "invwishart_cls_sample",
           "propose_truncnorm", "truncnorm_logratio", "NCClsInfo",
           "NCLogLike", "make_nc_log_likelihood", "nc_cls_sample",
           "CutMHPlan", "nc_cls_sample_cut", "whiten", "recenter"]


def standard_gamma(alpha: torch.Tensor, gen=None) -> torch.Tensor:
    """Gamma(alpha, 1) variates of alpha's shape for alpha >= 1 (Marsaglia
    & Tsang 2000; the conjugate draw's shapes are all >= 1.5).

    d = alpha - 1/3, c = 1/sqrt(9 d); propose v = (1 + c z)^3, z ~ N(0,1),
    accept when log U < z^2/2 + d - d v + d log v.  Each round proposes for
    every element still pending (acceptance >= 95%), so a few rounds
    suffice; one host sync per round."""
    if bool((alpha < 1.0).any()):
        raise ValueError("standard_gamma needs alpha >= 1")
    a = alpha
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    pending = torch.ones_like(a, dtype=torch.bool)
    while bool(pending.any()):
        z = torch.randn(a.shape, generator=gen, dtype=a.dtype, device=a.device)
        u = torch.rand(a.shape, generator=gen, dtype=a.dtype, device=a.device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        take = pending & ok
        out = torch.where(take, d * v, out)
        pending = pending & ~ok
    return out


def invgamma_dl(s_flat: torch.Tensor, bins: np.ndarray, lmax: int,
                gamma: torch.Tensor | None = None, gen=None) -> torch.Tensor:
    """Binned conjugate draw for one field, (..., nstate) -> (..., nbins).

    beta_bin = sum_l (2l+1) l(l+1) hat-C_l / (4 pi),
    alpha_bin = sum_l (2l+1)/2 - 1 (clamped to 1 where <= 0),
    D_bin = beta_bin / Gamma(alpha_bin).  ``gamma``: optional injected
    Gamma(alpha_bin) variates of the output's shape."""
    dt = s_flat.dtype
    cl_hat = alm2cl_state(s_flat, lmax)
    ell = torch.arange(lmax + 1, dtype=dt, device=s_flat.device)
    beta_l = (2.0 * ell + 1.0) * ell * (ell + 1.0) * cl_hat / (4.0 * np.pi)
    beta = bin_sum(beta_l, bins, lmax)
    alpha = bin_sum(2.0 * ell + 1.0, bins, lmax) / 2.0 - 1.0
    alpha = torch.where(alpha <= 0, 1.0, alpha)
    if gamma is None:
        gamma = standard_gamma(alpha.expand(beta.shape), gen)
    return beta / gamma


def centered_cls_sample(s: torch.Tensor, bins_list: Sequence[np.ndarray],
                        lmax: int, gammas=None, gen=None):
    """Independent binned inverse-gamma draws per field.  s: (...,
    nfields, nstate).  Returns a tuple of per-field (..., nbins_f) binned
    D_ell; ``gammas`` optionally injects one variate tensor per field."""
    if gammas is None:
        gammas = (None,) * len(bins_list)
    return tuple(invgamma_dl(s[..., f, :], bins, lmax, gamma=g, gen=gen)
                 for f, (bins, g) in enumerate(zip(bins_list, gammas)))


def invwishart_cls_sample(s: torch.Tensor, lmax: int, lmin: int = 2,
                          chi2=None, normals=None, gen=None) -> torch.Tensor:
    """Per-ell joint draw C_l ~ InvWishart(nu = 2l+1, Psi = S_l), S_l the
    k x k scatter sum_m a_lm a_lm^T of the fields s (..., k, nstate).
    Returns (..., lmax+1, k, k) C_ell blocks, zero below lmin.

    Bartlett: W ~ Wishart(nu, I) as L L^T with L lower triangular, diagonal
    sqrt(chi2_{nu - i}) and N(0, 1) below it; with cS = chol(S) the draw is
    C = cS (L L^T)^-1 cS^T.  ``chi2`` (..., lmax+1, k) and ``normals``
    (..., lmax+1, k, k) may be injected; otherwise chi2 = 2 Gamma(df / 2)
    through ``standard_gamma`` (df = max(nu - i, 1e-3)), then the normals,
    both from ``gen``.  The degrees below lmin are discarded, so their
    gamma shapes are drawn at 1; the kept ones need df >= 2 (lmin >= k/2)."""
    k = s.shape[-2]
    dt, dev = s.dtype, s.device
    L = lmax + 1
    batch = s.shape[:-2]
    g = s.reshape(s.shape[:-1] + (2, L, L))
    S = torch.einsum("...ipml,...jpml->...lij", g, g)
    if chi2 is None:
        if 2 * lmin + 1 - (k - 1) < 2:
            raise ValueError(f"lmin={lmin}: the Wishart degrees of freedom "
                             f"2 lmin + 1 - i fall below 2 for k={k}")
        nu = 2.0 * torch.arange(L, dtype=dt, device=dev) + 1.0
        df = torch.clamp(nu[:, None] - torch.arange(k, dtype=dt,
                                                     device=dev), min=1e-3)
        alpha = torch.where((torch.arange(L, device=dev) >= lmin)[:, None],
                            df / 2.0, 1.0)
        chi2 = 2.0 * standard_gamma(alpha.expand(batch + (L, k)), gen)
    if normals is None:
        normals = torch.randn(batch + (L, k, k), generator=gen, dtype=dt,
                              device=dev)
    Lmat = torch.tril(normals, diagonal=-1) + torch.diag_embed(
        torch.sqrt(chi2))
    eye = torch.eye(k, dtype=dt, device=dev)
    # a relative diagonal jitter of 1e-9: at high SNR the scatter can be
    # correlation-degenerate (|r| -> 1), and an absolute epsilon is dwarfed
    # by scatter scales ~1e3 muK^2; 1e-30 keeps the all-zero sub-lmin rows
    # factorable
    diagS = torch.diagonal(S, dim1=-2, dim2=-1)
    cS, info = torch.linalg.cholesky_ex(
        S + torch.diag_embed(1e-9 * diagS + 1e-30))
    cS = torch.where((info == 0)[..., None, None], cS, math.nan)
    inv_LLT, info = torch.linalg.inv_ex(Lmat @ Lmat.transpose(-1, -2)
                                        + 1e-30 * eye)
    inv_LLT = torch.where((info == 0)[..., None, None], inv_LLT, math.nan)
    C = cS @ inv_LLT @ cS.transpose(-1, -2)
    # where, not a product: sub-lmin rows may hold inf, and 0 * inf = nan
    keep = (torch.arange(L, device=dev) >= lmin)[:, None, None]
    return torch.where(keep, C, 0.0)


# ---------------------------------------------------------------------------
# Non-centered blocked Metropolis-within-Gibbs
# ---------------------------------------------------------------------------

def propose_truncnorm(x, sigma, u=None, gen=None):
    """x' ~ N(x, sigma^2) truncated to [0, inf), one U(0,1) per element.

    The JAX package's recipe (``jax.random.truncated_normal``), so that an
    injected ``u = jax.random.uniform(key, x.shape)`` reproduces its draw
    to rounding: a = erf(lower / sqrt 2), v = max(a, a + u (1 - a)),
    z = sqrt 2 erfinv(v), clipped to (lower, max float]."""
    lower = -x / sigma
    if u is None:
        u = torch.rand(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    sqrt2 = math.sqrt(2.0)
    a = torch.special.erf(lower / sqrt2)
    v = torch.maximum(a, u * (1.0 - a) + a)
    z = sqrt2 * torch.special.erfinv(v)
    lo = torch.nextafter(lower, torch.full_like(lower, math.inf))
    hi = torch.full_like(lower, torch.finfo(x.dtype).max)
    return x + sigma * torch.clamp(z, min=lo, max=hi)


def truncnorm_logratio(x_old, x_new, sigma):
    """log q(old | new) - log q(new | old) for the truncated-normal kernel:
    only the truncation normalizers survive."""
    return (torch.special.log_ndtr(x_old / sigma)
            - torch.special.log_ndtr(x_new / sigma))


def _dl_tuple_to_var(dl_tuple, bins_list, lmax, dtype):
    """Per-field binned D_ell (..., nbins_f) -> (..., nfields, nstate) prior
    variance."""
    return torch.stack([
        variance_expansion_state(unfold_bins(dl.to(dtype), bins, lmax), lmax)
        for dl, bins in zip(dl_tuple, bins_list)], dim=-2)


def whiten(s, dl_tuple, bins_list, lmax):
    """s_nc = C^-1/2 s (slots with C = 0 stay 0)."""
    var = _dl_tuple_to_var(dl_tuple, bins_list, lmax, s.dtype)
    inv_sqrt = torch.where(var > 0, 1.0 / torch.sqrt(
        torch.where(var > 0, var, 1.0)), 0.0)
    return s * inv_sqrt


def recenter(s_nc, dl_tuple, bins_list, lmax):
    """s = C^{1/2} s_nc."""
    var = _dl_tuple_to_var(dl_tuple, bins_list, lmax, s_nc.dtype)
    return torch.sqrt(var) * s_nc


class NCLogLike:
    """log L(dl_tuple; s_nc) of the non-centered parametrization, one value
    per chain, as a function of u = B sqrt(var(dl)) s_nc.  Calling it gives
    the total; ``at`` and ``delta`` give the total and then exact
    log-ratios between spectra, carrying u and its maps.  Three forms:

    - "cut": the cut-sky complement identity (``SkyModel.data_loglike_cut``
      and ``data_loglike_cut_delta``), maps = the cut (and hole) maps;
    - "pix": the full grid's -1/2 sum N^-1 (d - A u)^2, maps = (A u,);
    - "sph": the harmonic form on the full sky, -g/2 sum (d_alm - u)^2 with
      g = ``noise.harmonic_white_level()``, no maps.

    Each delta is formed term by term from the move's own synthesis and
    reduced in float64 beyond the last axis (``sum_last_f64``).
    ``var_fn(dl_tuple, dtype)``: the prior variance (default C(dl); the
    PNCP scheme's is 1 below l_cut)."""

    def __init__(self, model, bins_list, kind="cut", d_alm=None,
                 var_fn=None):
        if kind not in ("cut", "pix", "sph"):
            raise ValueError(f"kind={kind!r}; one of cut, pix, sph")
        if kind == "sph" and d_alm is None:
            raise ValueError("all_sph likelihood needs precomputed d_alm")
        self.model = model
        self.bins_list = bins_list
        self.kind = kind
        self.d_alm = d_alm
        self.var_fn = var_fn or (lambda dl, dt: _dl_tuple_to_var(
            dl, bins_list, model.lmax, dt))

    def _u(self, dl_tuple, s_nc):
        return self.model.beam(torch.sqrt(self.var_fn(dl_tuple, s_nc.dtype))
                               * s_nc)

    def _maps(self, u):
        m = self.model
        if self.kind == "cut":
            return m.synthesis_cut_sp(u)
        return (m.synthesis(u),) if self.kind == "pix" else ()

    def _ll(self, u, maps):
        m = self.model
        if self.kind == "cut":
            return m.data_loglike_cut(u, *maps)
        if self.kind == "pix":
            r = m.d - maps[0]
            return -0.5 * (m.noise.inv_noise * r * r).sum(
                dim=tuple(range(-(m.map_ndim + 1), 0)))
        g = m.noise.harmonic_white_level().to(u.dtype)[:, None]
        r = self.d_alm - u
        return -0.5 * (g * r * r).sum(dim=(-2, -1))

    def _dll(self, u, maps, du, dmaps):
        m = self.model
        if self.kind == "cut":
            return m.data_loglike_cut_delta(u, *maps, du, *dmaps)
        if self.kind == "pix":
            adu = dmaps[0]
            return -sum_last_f64(m.noise.inv_noise * adu * torch.add(
                maps[0], adu, alpha=0.5).sub_(m.d),
                m.map_ndim + 1).to(du.dtype)
        g = m.noise.harmonic_white_level().to(u.dtype)[:, None]
        return -sum_last_f64(g * du * torch.add(u, du, alpha=0.5).sub_(
            self.d_alm), 2).to(du.dtype)

    def __call__(self, dl_tuple, s_nc):
        u = self._u(dl_tuple, s_nc)
        return self._ll(u, self._maps(u))

    def at(self, dl_tuple, s_nc):
        """(log L, carry) at ``dl_tuple``; carry = (u, *maps)."""
        u = self._u(dl_tuple, s_nc)
        maps = self._maps(u)
        return self._ll(u, maps), (u, *maps)

    def delta(self, carry, dl_old, dl_new, s_nc):
        """(log L(dl_new) - log L(dl_old), carry at dl_new), ``carry`` the
        one at ``dl_old``: one synthesis of the move, none of a total."""
        u, *maps = carry
        dt = s_nc.dtype
        du = self.model.beam((torch.sqrt(self.var_fn(dl_new, dt))
                              - torch.sqrt(self.var_fn(dl_old, dt))) * s_nc)
        dmaps = self._maps(du)
        dll = self._dll(u, maps, du, dmaps)
        return dll, (u + du, *(None if a is None else a + b
                               for a, b in zip(maps, dmaps)))


def make_nc_log_likelihood(model, bins_list, all_sph: bool = False,
                           d_alm=None):
    """The non-centered log-likelihood (:class:`NCLogLike`): the harmonic
    form with ``all_sph`` (full sky; needs ``d_alm``, the data's alm), else
    the cut-sky complement form on a cut-decomposition model, else the
    full grid's pixel form."""
    if all_sph:
        return NCLogLike(model, bins_list, "sph", d_alm=d_alm)
    return NCLogLike(model, bins_list, "cut" if model.has_cut else "pix")


def _select(acc, new, old):
    """Per chain: ``new`` where ``acc`` else ``old`` (None stays None)."""
    if new is None:
        return None
    return torch.where(acc.reshape(acc.shape + (1,) * (new.ndim - acc.ndim)),
                       new, old)


class NCClsInfo(NamedTuple):
    accept: tuple             # per-field (..., nblocks_f) accept means
    log_like: torch.Tensor    # (...,)


def _block_table(blocks_list, sizes):
    """(nblocks, ntot) float64 one-hot rows of the blocks, field by field."""
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    rows = []
    for f, blocks in enumerate(blocks_list):
        for (lo, hi) in blocks:
            r = np.zeros(int(offs[-1]))
            r[offs[f] + lo: offs[f] + hi] = 1.0
            rows.append(r)
    return np.stack(rows), offs


def _sigma_vec(prop_sigma_list, sizes, dtype, device):
    return torch.cat([torch.as_tensor(np.broadcast_to(
        np.asarray(p, dtype=np.float64), (n,)).copy(), dtype=dtype,
        device=device) for p, n in zip(prop_sigma_list, sizes)])


def _mh_uniforms(batch, n_iter, ntot, nblocks, like, u_prop, u_acc, gen):
    """The sweep uniforms: injected, or drawn from ``gen``."""
    kw = dict(generator=gen, dtype=like.dtype, device=like.device)
    if u_prop is None:
        u_prop = torch.rand(batch + (n_iter, ntot), **kw)
    if u_acc is None:
        u_acc = torch.rand(batch + (n_iter, nblocks), **kw)
    return u_prop.to(like.dtype), u_acc.to(like.dtype)


def _split_accepts(accs, blocks_list):
    """(n_iter, ..., nblocks) indicators -> per-field (..., nblocks_f)
    means over the sweeps."""
    acc_mean = accs.mean(dim=0)
    out, i0 = [], 0
    for blocks in blocks_list:
        out.append(acc_mean[..., i0: i0 + len(blocks)])
        i0 += len(blocks)
    return tuple(out)


def nc_cls_sample(dl_tuple, s_nc, log_like_fn, bins_list, blocks_list,
                  prop_sigma_list, n_iter: int = 1, u_prop=None, u_acc=None,
                  gen=None):
    """Blocked MH sweep(s) over binned D_ell given the whitened map s_nc.

    blocks_list[f]     : (start, stop) bin-index ranges of field f
    prop_sigma_list[f] : (nbins_f,) proposal std devs
    n_iter             : MH sweeps per call

    Per sweep: propose every bin once (truncated normal), then accept or
    reject block by block, field by field, each decision on the exact
    log-ratio of one synthesis of the move (``log_like_fn``, an
    :class:`NCLogLike`).  The direct path, and the oracle of
    ``nc_cls_sample_cut``."""
    dt = dl_tuple[0].dtype
    dev = dl_tuple[0].device
    nfields = len(dl_tuple)
    sizes = [int(d.shape[-1]) for d in dl_tuple]
    table, offs = _block_table(blocks_list, sizes)
    bmask = torch.as_tensor(table, dtype=dt, device=dev)
    nblocks, ntot = table.shape
    sigma = _sigma_vec(prop_sigma_list, sizes, dt, dev)

    def split_fields(dvec):
        return tuple(dvec[..., offs[f]: offs[f + 1]] for f in range(nfields))

    dl = torch.cat([d.to(dt) for d in dl_tuple], dim=-1)
    batch = tuple(dl.shape[:-1])
    u_prop, u_acc = _mh_uniforms(batch, n_iter, ntot, nblocks, dl, u_prop,
                                 u_acc, gen)
    ll, carry = log_like_fn.at(dl_tuple, s_nc)
    accs = []
    for it in range(n_iter):
        props = propose_truncnorm(dl, sigma, u_prop[..., it, :])
        lr_vec = truncnorm_logratio(dl, props, sigma)
        log_u = torch.log(u_acc[..., it, :])
        acc_it = []
        for b in range(nblocks):
            cand = torch.where(bmask[b] > 0, props, dl)
            dll, carry_c = log_like_fn.delta(carry, split_fields(dl),
                                             split_fields(cand), s_nc)
            qcorr = (bmask[b] * lr_vec).sum(-1)
            acc = log_u[..., b] < dll + qcorr
            dl = torch.where(acc[..., None], cand, dl)
            ll = torch.where(acc, ll + dll, ll)
            carry = tuple(_select(acc, c, o) for c, o in zip(carry_c, carry))
            acc_it.append(acc.to(dt))
        accs.append(torch.stack(acc_it, dim=-1))
    return split_fields(dl), NCClsInfo(
        accept=_split_accepts(torch.stack(accs), blocks_list), log_like=ll)


def _per_ell(y, lmax):
    """(..., nstate) -> (..., L) sums over the (part, m) axes."""
    L = lmax + 1
    return y.reshape(y.shape[:-1] + (2, L, L)).sum(dim=(-3, -2))


def _mdomain_eligible(model) -> bool:
    """Static eligibility of the m-domain singles sweep: azimuthally
    uniform cut weights, dense (not ring-split) cut tables and a cut-ring
    nphi >= 2 lmax, so that the ring Parseval identity is exact."""
    cut = model.cut_sht
    return (getattr(model, "cut_w_uniform", False)
            and cut is not None
            and not getattr(cut, "ring_split", False)
            and getattr(cut, "nphi", 0) >= 2 * model.lmax)


# chunk size of the m-domain singles sweeps: at most this many bins AND
# this many selected ells per chunk (bounds the chunk's live (..., L, J, J)
# tables and (..., nb, ncomp, nr, L) coefficients)
_MDOMAIN_CHUNK = 16
# chunk size of the phi-domain singles sweep: its per-bin map stack, (...,
# nb, ncomp, nr, nphi), is the largest live tensor of that engine
_PHI_CHUNK = 16


def _prepare_mchunks(singles, single_rows, bins_list,
                     chunk_size: int | None = None):
    """Static chunking of the single-bin blocks for the m-domain sweep:
    field-pure chunks of at most chunk_size bins AND at most chunk_size
    selected ells (wide bins count by their ell width), each described by
    (field, j_idx, seg, gbins, rows) with j_idx the chunk's selected ells
    and seg the (J, nb) segment matrix (None when all bins are single
    ells)."""
    if chunk_size is None:
        chunk_size = _MDOMAIN_CHUNK
    groups = []
    cur = None
    for (f, lo, gi), row in zip(singles, single_rows):
        bins_f = np.asarray(bins_list[f])
        js = list(range(int(bins_f[lo]), int(bins_f[lo + 1])))
        if cur is None or cur["f"] != f or len(cur["gbins"]) >= chunk_size \
                or len(cur["j"]) >= chunk_size:
            cur = {"f": f, "j": [], "wid": [], "gbins": [], "rows": []}
            groups.append(cur)
        cur["j"].extend(js)
        cur["wid"].append(len(js))
        cur["gbins"].append(gi)
        cur["rows"].append(row)
    out = []
    for c in groups:
        j_idx = np.asarray(c["j"], dtype=np.int64)
        nb = len(c["gbins"])
        if all(w == 1 for w in c["wid"]):
            seg = None
        else:
            seg = np.zeros((len(j_idx), nb))
            k = 0
            for b, w in enumerate(c["wid"]):
                seg[k: k + w, b] = 1.0
                k += w
        out.append((c["f"], j_idx, seg,
                    np.asarray(c["gbins"]), np.asarray(c["rows"])))
    return out


def _chunk_comps(model, f) -> tuple:
    """The map components field f occupies in the map axis: (0,) for a
    spin-0 field (T), (0, 1) for E or B of a spin-2 model, (1, 2) for E or B
    of a joint TQU model."""
    if model.spin == 0 or (model.spin == 3 and f == 0):
        return (0,)
    return (0, 1) if model.spin == 2 else (1, 2)


def _spin2_which(model, f) -> str:
    """"e" or "b": which spin-2 field of the model field f is."""
    return "e" if f == model._e else "b"


def _prepare_mgrids(model, t, fields):
    """The Legendre-stage input grids of the per-bin components t_f, once
    per field the chunks use: {field: ("s0"|"s2", grid, sign_p, sign_m)}."""
    cut = model.cut_sht
    grids = {}
    for f in sorted(fields):
        if len(_chunk_comps(model, f)) == 1:
            grids[f] = ("s0", cut._state_grids(t[..., f, :]), 1.0, 1.0)
        else:
            g, sp, sm = cut.lsel_grid_spin2_single(t[..., f, :],
                                                   _spin2_which(model, f))
            grids[f] = ("s2", g, sp, sm)
    return grids


def _prepare_tchunks(model, cut, mchunks, w1, dt, nyq: bool = False):
    """Per-chunk ell-pair weight tables of the table-domain reductions.

    The w-weighted dot product of two per-bin components factorizes
    through the ring Parseval identity into ell-pair tables contracted
    against per-(m, ell) state products,

        <a_i, a_j>_w = nphi sum_m C_ij(m) [Wpp + pos_m Wmm](m, li, lj),
        W__(m, l, l') = sum_r w_r lam_(m,l,r) lam_(m,l',r),

    so no per-bin (ring, m) planes are ever built.  Ring phases rotate the
    (re, im) coefficient pairs jointly and the like-component pairing is
    rotation-invariant, so the tables hold on phased rows too; only the
    pairings with the raw ring sums (rho, the residual updates) need the
    rotation, in the sweep.

    ``nyq``: the rows sit at nphi = 2 lmax, where the m = lmax column
    carries (pw_cos, pw_sin) = (nphi, 0) and the uniform pairing above is
    wrong.  The column is zeroed out of the tables here and its exact
    contribution added by its own path in the sweep, from the raw lambda
    column(s) each chunk carries.  Returns per chunk (kind, lamA, lamB, W,
    omega, lnyq): lnyq is None, the (J, nr) spin-0 column, or the (lam+2,
    lam-2) pair of spin-2 columns.

    With tables narrower than the compute dtype, as in the JAX package: the
    tables keep their table-dtype values (held in ``dt``; the sweep's
    contractions with them run in ``dt``), and W weighs them with the
    weights rounded to the table dtype (``w1.astype(lam_j.dtype)``).  The
    JAX source forms that weighted table in the table dtype; compiled,
    XLA keeps a bfloat16 product in float32 when W is summed in float32
    (its default excess precision: the product of two bfloat16 values is
    exact in float32) and rounds it to the table dtype when W is summed in
    float64; a float16 product it rounds to float16 at both.  The port
    does the same (``weighted``).  A wider (float64) table under float32:
    W is the JAX package's float64 einsum of the float64 product and the
    table, rounded once to ``dt``; the tables are held in ``dt``, so the
    sweep contracts them rounded to it (the JAX package promotes those
    contractions to float64)."""
    n = float(cut.nphi)
    L = model.lmax + 1
    pos = cut.pos.to(dt)
    td = cut.table_dtype
    narrow = td.itemsize < cut.dtype.itemsize
    if narrow:
        w1 = cast_to(w1, td).to(dt)

    def weighted(lam_j):
        """lam_j * w1 as the compiled JAX package forms it."""
        lw = lam_j * w1
        rounds = dt == torch.float64 or td == torch.float16
        return cast_to(lw, td).to(dt) if narrow and rounds else lw

    def table(lam):
        """The chunk's (L, J, nr) slice of ``lam``, in ``dt`` or (a wider
        table) in the table dtype until W is formed."""
        return cut.lsel_table(lam, j_idx).to(td if cut.wide else dt)

    def wsum(lam_j):
        """W = sum_r (lam_j w1) lam_j, rounded to ``dt``."""
        return torch.einsum("mjr,mkr->mjk", weighted(lam_j), lam_j).to(dt)
    out = []
    for (f, j_idx, seg, gbins, rows) in mchunks:
        # lsel_table gathers a fresh (L, J, nr) tensor: zeroing its Nyquist
        # row leaves the transform's table as it is
        if len(_chunk_comps(model, f)) == 1:
            lam0_j = table(cut.lam0)                              # (L, J, r)
            lnyq = None
            if nyq:
                lnyq = lam0_j[L - 1].to(dt, copy=True)
                lam0_j[L - 1] = 0.0
            W00 = wsum(lam0_j)
            lam0_j = lam0_j.to(dt)
            omega = np.full((2, L), 2.0 * n)
            omega[0, 0] = n
            omega[1, 0] = 0.0
            out.append(("s0", lam0_j, None, W00,
                        torch.as_tensor(omega, dtype=dt, device=w1.device),
                        lnyq))
        else:
            lamp_j, lamm_j = table(cut.lam_p2), table(cut.lam_m2)
            lnyq = None
            if nyq:
                lnyq = (lamp_j[L - 1].to(dt, copy=True),
                        lamm_j[L - 1].to(dt, copy=True))
                lamp_j[L - 1] = 0.0
                lamm_j[L - 1] = 0.0
            Wpp, Wmm = wsum(lamp_j), wsum(lamm_j)
            out.append(("s2", lamp_j.to(dt), lamm_j.to(dt),
                        n * (Wpp + pos[:, None, None] * Wmm), None, lnyq))
    return out


class _Chunk(NamedTuple):
    """One chunk of single-bin blocks of one field: its gather indices on
    the device and what its engine needs."""
    f: int
    comps: tuple               # the field's map components
    j_idx: torch.Tensor        # (J,) selected ells
    segj: torch.Tensor | None  # (J, nb) segment matrix of wide bins
    gbins: torch.Tensor        # (nb,) global bin indices
    rows: torch.Tensor         # (nb,) block rows
    kind: str                  # "s0" (spin-0 field) or "s2"
    # the table engine
    lamA: torch.Tensor | None = None   # (L, J, nr)
    lamB: torch.Tensor | None = None
    W: torch.Tensor | None = None      # (L, J, J)
    omega: torch.Tensor | None = None
    lnyq: object = None                # None, or the Nyquist lambda column(s)
    sp_tab: torch.Tensor | None = None  # (J, 2L, ncomp S) hole slot tables
    # the coefficient engine: per (cos, sin) the sqrt(w pw) scale of the
    # coefficients, the factor of the residual's ring sums in rho and that
    # of the residual fold, each (ncomp, nr, L)
    sc: tuple | None = None
    rfac: tuple | None = None
    dfac: tuple | None = None
    # the phi-domain engine: the (nb, L) host ell selector of the bins
    sel: np.ndarray | None = None


def _engine_of(model, mdomain, singles) -> str:
    """The engine the JAX package picks for ``nc_cls_sample_cut``:

    - the m domain needs single-bin blocks, an ``mdomain`` that is not
      False and azimuthally uniform cut weights on rows with nphi >= 2
      lmax (``_mdomain_eligible``);
    - there the table domain ("table") needs ``mdomain`` other than "m"
      and cut weights equal across the map components; otherwise the
      coefficient domain ("coef") runs, except under the sparse split,
      which the coefficient engine does not carry: then phi;
    - everything else runs the phi domain ("phi")."""
    tab_ok = (mdomain != "m" and getattr(model, "cut_w_equal_fields", False)
              and getattr(model.cut_sht, "nphi", 0) >= 2 * model.lmax)
    use_m = mdomain is not False and bool(singles) and _mdomain_eligible(
        model)
    if use_m and model.has_sparse:
        use_m = tab_ok
    if not use_m:
        return "phi"
    return "table" if tab_ok else "coef"


class CutMHPlan:
    """The static part of ``nc_cls_sample_cut`` for one model, binning and
    blocking, built once on the model's device: the proposal scale, block
    table and order, the engine the JAX package would pick
    (``_engine_of``), the chunking of the single-bin blocks with their
    gather indices and what the engine needs per chunk:

    - "table" (the table domain): the ell-pair W tables, the cut rows'
      phase factors (phi0 != 0) and Nyquist columns (nphi = 2 lmax) and,
      for a model with the sparse split, the hole points' slot tables
      (``PointSHT.flat_tables_spin*``);
    - "coef" (the coefficient m domain): the sqrt(w pw) scales of the
      per-bin ring half-spectrum coefficients and their where-guarded
      inverses at w = 0 rings;
    - "phi" (the phi domain): chunks of at most ``_PHI_CHUNK`` bins, each
      with its ell selector; the per-bin maps are built in the sweep.

    These depend only on the model, the bins and the blocks (the JAX
    package rebuilds them inside ``jit`` on every call; the values are the
    same).  The proposal scale ``sigma`` is replaced in place by
    ``set_sigma``, which rebuilds nothing.

    ``mdomain``: "auto" (or True) lets the engine follow the model, "m"
    pins the coefficient engine where the m domain is eligible and the
    model has no sparse split, False pins the phi engine.

    ``l_cut_identity`` (the PNCP scheme): an int, or one value per field
    (a sequence or an ndarray); the slots with l < l_cut of each field are
    re-centered by the identity, u = B s_nc there, whatever D_ell.  The
    plan holds the low-ell mask and its complement; each call adds the
    fixed u_base = B (s_nc low) to the state u(dl) and so to u0 and the
    residual it starts from.  The blocks must touch bins at l >= l_cut
    only (``PNCPGibbs`` keeps those), so the singles' components, their
    chunk gathers and the big blocks' moves are those of the plain
    engine."""

    def __init__(self, model, bins_list, blocks_list, prop_sigma_list,
                 mdomain="auto", l_cut_identity=None, dtype=None):
        if not model.has_cut:
            raise ValueError(
                "nc_cls_sample_cut needs a cut-decomposition model")
        cut = model.cut_sht
        dt = dtype or cut.dtype
        dev = cut.device
        lmax = model.lmax
        L = lmax + 1
        self.model = model
        self.dtype = dt
        self.bins_list = tuple(np.asarray(b, dtype=np.int64)
                               for b in bins_list)
        self.blocks_list = tuple(tuple((int(lo), int(hi)) for lo, hi in bl)
                                 for bl in blocks_list)
        self.sizes = [len(b) - 1 for b in self.bins_list]
        table, self.offs = _block_table(self.blocks_list, self.sizes)
        self.nblocks, self.ntot = table.shape
        self.bmask = torch.as_tensor(table, dtype=dt, device=dev)
        self.sigma = _sigma_vec(prop_sigma_list, self.sizes, dt, dev)

        order, singles, brow = [], [], 0
        for f, blocks in enumerate(self.blocks_list):
            for (lo, hi) in blocks:
                if hi - lo == 1:
                    order.append(("single", f, brow))
                    singles.append((f, lo, int(self.offs[f]) + lo))
                else:
                    order.append(("big", f, brow))
                brow += 1
        kinds = [k for (k, *_r) in order]
        if "single" in kinds and "big" in kinds[kinds.index("single"):]:
            raise ValueError("nc_cls_sample_cut requires all multi-bin "
                             "blocks to precede the single-bin blocks; use "
                             "nc_cls_sample for this blocking")
        self.big_rows = [row for (k, _f, row) in order if k == "big"]
        self.big_fields = [f for (k, f, _row) in order if k == "big"]
        single_rows = [row for (k, _f, row) in order if k == "single"]
        self.engine = _engine_of(model, mdomain, singles)

        self.nphi = float(cut.nphi)
        # the raw ring sums rotate into the unrotated-F pairing basis by
        # the cut rows' phase factors
        self.ph_c = self.ph_s = None
        if cut.has_phase:
            self.ph_c = cut.phase_cos.to(dt)               # (ncut, L)
            self.ph_s = cut.phase_sin.to(dt)
        self.pos = cut.pos.to(dt)
        self.cmv = torch.full((L,), 2.0, dtype=dt, device=dev)
        self.cmv[0] = 1.0
        self.w_cut = model.w_cut.to(dt)                     # (nmaps, ncut, nphi)
        idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=dev)
        # the sparse split: the hole data and weights, padded (the phi
        # engine) and on the flat slot axis, (..., nmaps * nslots) (the
        # table engine)
        self.spt = model.sp_sht
        if self.spt is not None:
            self.d_sp = model.d_sp.to(dt)
            self.w_sp = model.w_sp.to(dt)
            self.w_sp_flat = self.spt.flat_of(self.w_sp).flatten(-2)

        mchunks = _prepare_mchunks(
            singles, single_rows, self.bins_list,
            chunk_size=_PHI_CHUNK if self.engine == "phi" else None)
        self.chunks = [
            _Chunk(f=f, comps=_chunk_comps(model, f), j_idx=idx(j_idx),
                   segj=(None if seg is None else
                         torch.as_tensor(seg, dtype=dt, device=dev)),
                   gbins=idx(gbins), rows=idx(rows),
                   kind="s0" if len(_chunk_comps(model, f)) == 1 else "s2")
            for (f, j_idx, seg, gbins, rows) in mchunks]
        self.fields = sorted({c.f for c in self.chunks})
        if self.engine == "phi":
            self.chunks = [c._replace(sel=_chunk_sel(j, seg, L))
                           for c, (_f, j, seg, *_r) in zip(self.chunks,
                                                           mchunks)]
        else:
            self.pwc, self.pws = (w.to(dt) for w in cut.ring_dot_weights())
            if self.engine == "table":
                self._table_chunks(model, mchunks)
            else:
                self._coef_chunks()

        # per-call harmonic constants: the per-bin component filter and the
        # valid-slot mask
        fac = dl_to_cl_factor(lmax, dt, dev)
        self.tfl = model.bl.to(dt) * torch.sqrt(fac)
        self.valid = torch.as_tensor(state_masks(lmax).valid, dtype=dt,
                                     device=dev)               # (2, L, L)
        self.g = (model.noise.tau_max / model.noise.omega).to(dt)
        # the identity re-centering below l_cut: (nfields, nstate) masks
        self.lowm = self.him = None
        if l_cut_identity is not None:
            nf = len(self.bins_list)
            lcs = ([int(l_cut_identity)] * nf if np.ndim(l_cut_identity) == 0
                   else [int(c) for c in l_cut_identity])
            if len(lcs) != nf:
                raise ValueError(f"l_cut_identity={l_cut_identity}: need one "
                                 f"value or one per field ({nf})")
            low = torch.as_tensor(np.stack([np.arange(L) < lc for lc in lcs]),
                                  dtype=dt, device=dev)
            self.lowm = expand_cl_state(low, lmax)
            self.him = 1.0 - self.lowm

    def _table_chunks(self, model, mchunks):
        """The table engine's per-chunk tables (``_prepare_tchunks``) and,
        with the sparse split, hole slot tables."""
        cut, dt = model.cut_sht, self.dtype
        # the cut weights are uniform along each ring and equal across map
        # components
        self.w1 = self.w_cut[0, :, 0]                       # (ncut,)
        tpre = _prepare_tchunks(model, cut, mchunks, self.w1, dt,
                                nyq=cut.nphi == 2 * model.lmax)

        def sp_tab(f, j_idx):
            if self.spt is None:
                return None
            if len(_chunk_comps(model, f)) == 1:
                return self.spt.flat_tables_spin0(j_idx, dt)
            return self.spt.flat_tables_spin2(
                *SPIN2_SINGLE_SIGNS[_spin2_which(model, f)], j_idx, dt)

        self.chunks = [
            c._replace(lamA=lamA, lamB=lamB, W=W, omega=omega, lnyq=lnyq,
                       sp_tab=sp_tab(f, j_idx))
            for c, (f, j_idx, *_r), (_k, lamA, lamB, W, omega, lnyq)
            in zip(self.chunks, mchunks, tpre)]

    def _coef_chunks(self):
        """The coefficient engine's per-chunk scales: the coefficients are
        scaled by sqrt(w_r pw_m), so that <a_i, a_j>_w is a plain product of
        the scaled coefficients; rho and the residual fold carry the
        compensating factors on the ring sums' side.  Rings with w_r = 0
        feed no w-weighted product downstream, so the where-guards there
        are exact."""
        w_ring = self.w_cut[..., 0]                         # (nmaps, ncut)
        out = []
        for c in self.chunks:
            wf = w_ring[c.comps[0]: c.comps[-1] + 1][:, :, None]
            sc = tuple(torch.sqrt(wf * pw) for pw in (self.pwc, self.pws))
            rfac = tuple(torch.where(pw > 0, s / torch.where(pw > 0, pw, 1.0),
                                     0.0)
                         for s, pw in zip(sc, (self.pwc, self.pws)))
            dfac = tuple(torch.where(s > 0, pw / torch.where(s > 0, s, 1.0),
                                     0.0)
                         for s, pw in zip(sc, (self.pwc, self.pws)))
            out.append(c._replace(sc=sc, rfac=rfac, dfac=dfac))
        self.chunks = out

    def set_sigma(self, prop_sigma_list):
        """Replace the proposal scales in place: the same ``sigma`` tensor,
        every table of the plan untouched."""
        self.sigma.copy_(_sigma_vec(prop_sigma_list, self.sizes,
                                    self.sigma.dtype, self.sigma.device))

    def components(self, s_nc):
        """The per-bin components t = B sqrt(2 pi / l(l+1)) s_nc and their
        valid-masked copy tv, (..., nfields, nstate) each."""
        lmax = self.model.lmax
        L = lmax + 1
        t = almxfl_state(s_nc.to(self.dtype), self.tfl, lmax)
        tv = (t.reshape(t.shape[:-1] + (2, L, L)) * self.valid).reshape(
            t.shape)
        return t, tv

    def _sqrt_per_ell(self, dlcat, f):
        """sqrt(D_ell) of field f per ell from the concatenated binned
        D_ell."""
        return torch.sqrt(unfold_bins(dlcat[..., self.offs[f]:
                                            self.offs[f + 1]],
                                      self.bins_list[f], self.model.lmax))

    def _scale(self, tf, fac):
        """One field's components tf times its per-ell factor fac."""
        L = self.model.lmax + 1
        return (tf.reshape(tf.shape[:-1] + (2, L, L))
                * fac[..., None, None, :]).reshape(tf.shape)

    def base(self, s_nc):
        """u_base = B (s_nc low), the identity re-centered part of u below
        l_cut; None without ``l_cut_identity``."""
        if self.lowm is None:
            return None
        return almxfl_state(s_nc.to(self.dtype) * self.lowm,
                            self.model.bl.to(self.dtype), self.model.lmax)

    def u_of(self, dlcat, tv, u_base=None):
        """u(dl) = sqrt(C_l(dl)) t over the fields: (..., nfields, nstate)
        from the concatenated binned D_ell and the valid-masked components
        ``tv``; with ``u_base`` (``base``), u_base + him u(dl)."""
        u = torch.stack([self._scale(tv[..., f, :],
                                     self._sqrt_per_ell(dlcat, f))
                         for f in range(len(self.bins_list))], dim=-2)
        return u if u_base is None else u_base + self.him * u

    def du_of(self, dl_new, dl_old, tv, field):
        """u(dl_new) - u(dl_old) for a move of ``field``'s D_ell alone: the
        per-ell factor sqrt(D_new) - sqrt(D_old), formed before the product
        with tv (exactly 0 on the bins where the two agree), and zero on
        the other fields."""
        du = torch.zeros_like(tv)
        du[..., field, :] = self._scale(
            tv[..., field, :], self._sqrt_per_ell(dl_new, field)
            - self._sqrt_per_ell(dl_old, field))
        return du

    def big_dll(self, tv, dl_old, dl_new, u, au_cut, au_sp, field):
        """The exact log-likelihood ratio of a multi-bin block's candidate,
        the block on ``field``: (dll, du, A_cut du, A_sp du), one synthesis
        of the move du onto every map component."""
        du = self.du_of(dl_new, dl_old, tv, field)
        adu_cut, adu_sp = self.model.synthesis_cut_sp(du)
        dll = self.model.data_loglike_cut_delta(u, au_cut, au_sp, du,
                                                adu_cut, adu_sp, field)
        return dll, du, adu_cut, adu_sp

    def residual(self, r_cut, au_sp):
        """The residual the engine's singles carry, from the cut residual
        maps d_cut - A_cut u and the hole values A_sp u (None without the
        split): in the m domain the ring sums (Rc, Rs) and the hole
        residual d_sp - A_sp u on the flat slot axis, (..., nmaps *
        nslots); in the phi domain the maps and padded values
        themselves."""
        r_sp = None if au_sp is None else self.d_sp - au_sp
        if self.engine == "phi":
            return r_cut, r_sp
        return (*self.model.cut_sht.ring_cs_of_maps(r_cut),
                None if r_sp is None else self.spt.flat_of(r_sp).flatten(-2))

    def move_residual(self, res, acc, adu, adu_sp):
        """``res`` (``residual``) after the move with cut maps ``adu`` and
        hole values ``adu_sp``, on the chains where ``acc``."""
        if self.engine == "phi":
            resid, rp = res
            return (_select(acc, resid - adu, resid),
                    None if rp is None else _select(acc, rp - adu_sp, rp))
        Rc, Rs, Rp = res
        Rc_d, Rs_d = self.model.cut_sht.ring_cs_of_maps(adu)
        if Rp is not None:
            Rp = _select(acc, Rp - self.spt.flat_of(adu_sp).flatten(-2), Rp)
        return _select(acc, Rc - Rc_d, Rc), _select(acc, Rs - Rs_d, Rs), Rp


def _chunk_sel(j_idx, seg, L) -> np.ndarray:
    """The (nb, L) 0/1 ell selector of a chunk's bins."""
    j_idx = np.asarray(j_idx)
    nb = len(j_idx) if seg is None else seg.shape[1]
    sel = np.zeros((nb, L))
    if seg is None:
        sel[np.arange(nb), j_idx] = 1.0
    else:
        sel[np.argmax(seg, axis=1), j_idx] = 1.0
    return sel


def nc_cls_sample_cut(dl_tuple, s_nc, model, bins_list, blocks_list,
                      prop_sigma_list, n_iter: int = 1, mdomain="auto",
                      l_cut_identity=None, u_prop=None, u_acc=None, gen=None,
                      plan: CutMHPlan | None = None):
    """Rank-one fast path of :func:`nc_cls_sample` for cut-decomposition
    models: the same Markov kernel on the same uniforms, scalar-cost
    single-bin blocks.

    The whitened likelihood is quadratic in u(dl) = B sqrt(var(dl)) s_nc,
    and u is linear in the per-bin sqrt(D_i) with mutually orthogonal
    per-bin components t_i (disjoint ell supports),

        u = sum_i sqrt(D_i) t_i,   t_i = B sqrt(2 pi / l(l+1)) s_nc|_{bin i},

    so a single-bin block's candidate changes u by gamma t_i (gamma =
    sqrt(D') - sqrt(D)) and its log-likelihood change is

        dll = gamma (alpha_i - sqrt(D_i) beta_i - <w r, A t_i>)
              + gamma^2 (q_i - beta_i) / 2

    with alpha_i = <c1, t_i>, beta_i = g ||t_i||^2, q_i = ||sqrt(w) A t_i||^2
    and r the cut residual.  Under the sparse split every per-bin scalar
    gains its hole-point term (q_i += ||sqrt(w_sp) A_sp t_i||^2, rho
    likewise) and the hole residual is carried too.  Multi-bin ("big")
    blocks are evaluated directly, each on the exact log-ratio of one cut
    synthesis of its move (``CutMHPlan.big_dll``; u and its maps are
    synthesized once per sweep), then the singles run chunk by chunk on the
    plan's engine (``CutMHPlan``):

    - table / coef (the m domain): the residual is carried as its ring sums
      (Rc, Rs) (and the hole residual on the flat slot axis, Rp); per chunk
      q_i, the in-chunk Gram G_ij = <a_i, a_j>_w and rho_i = <r, a_i>_w,
      from the ell-pair W tables (table) or from the sqrt(w pw)-scaled ring
      coefficients of the per-bin components (coef), then a scalar scan
      with cwr_i = rho_i - sum_{j<i} gamma_j G_ij and one fold of the
      accepted moves into the residual;
    - phi: the residual is carried as maps (and hole values); per chunk the
      per-bin maps A t_i (and A_sp t_i) from one ell-selected synthesis,
      then a scan over the bins that reads and updates the residual.

    All three engines accept on the same ``u_acc`` slots.  ``plan``: the
    static part, built here when not given.  ``u_prop`` / ``u_acc``:
    injected sweep uniforms (module docstring)."""
    dt = dl_tuple[0].dtype
    if plan is None:
        plan = CutMHPlan(model, bins_list, blocks_list, prop_sigma_list,
                         mdomain=mdomain, l_cut_identity=l_cut_identity,
                         dtype=dt)
    elif plan.dtype != dt or plan.model is not model:
        raise ValueError("plan was built for another model or dtype")
    lmax = model.lmax
    nfields = len(dl_tuple)
    offs = plan.offs

    # ---- per-call precomputation (depends on s_nc) ------------------------
    t, tv = plan.components(s_nc)                          # (..., nf, nstate)
    u_base = plan.base(s_nc)
    alpha = torch.cat([
        bin_sum(_per_ell(model.cut_c1[f].to(dt) * t[..., f, :], lmax), bins,
                lmax) for f, bins in enumerate(plan.bins_list)], dim=-1)
    beta = torch.cat([
        plan.g[f] * bin_sum(_per_ell(t[..., f, :] * t[..., f, :], lmax),
                            bins, lmax)
        for f, bins in enumerate(plan.bins_list)], dim=-1)
    grids = (None if plan.engine == "phi"
             else _prepare_mgrids(model, t, plan.fields))

    dlcat = torch.cat([d.to(dt) for d in dl_tuple], dim=-1)
    batch = tuple(dlcat.shape[:-1])
    u_prop, u_acc = _mh_uniforms(batch, n_iter, plan.ntot, plan.nblocks,
                                 dlcat, u_prop, u_acc, gen)
    d_cut = model.d_cut.to(dt)
    accs = []
    for it in range(n_iter):
        # the state the big blocks move from, with its maps: once per
        # sweep (the singles carry only the residual)
        u = plan.u_of(dlcat, tv, u_base)
        au, au_sp = model.synthesis_cut_sp(u)
        if it == 0:
            ll = model.data_loglike_cut(u, au, au_sp)
            res = plan.residual(d_cut - au, au_sp)
        dlcat, ll, res, acc_it = _sweep(
            plan, model, grids, t, tv, alpha, beta, dlcat, ll, (u, au, au_sp),
            res, u_prop[..., it, :], u_acc[..., it, :])
        accs.append(acc_it)
    dl_out = tuple(dlcat[..., offs[f]: offs[f + 1]] for f in range(nfields))
    return dl_out, NCClsInfo(
        accept=_split_accepts(torch.stack(accs), plan.blocks_list),
        log_like=ll)


def _sweep(plan, model, grids, t, tv, alpha, beta, dlcat, ll, state, res,
           up, ua):
    """One sweep over every chain: propose, the big blocks, then the
    singles chunk by chunk on the plan's engine.  ``state`` is (u, A_cut u,
    A_sp u) at ``dlcat``, owned by the sweep (u is updated in place);
    ``res`` is the residual in the engine's form (``CutMHPlan.residual``),
    owned by the sweep too.  Returns (dlcat, ll, res, accs)."""
    dt = dlcat.dtype
    props = propose_truncnorm(dlcat, plan.sigma, up)
    lr_vec = truncnorm_logratio(dlcat, props, plan.sigma)
    log_u = torch.log(ua)                                   # (..., nblocks)
    accs = torch.zeros_like(log_u)

    u, au, au_sp = state
    big = list(zip(plan.big_rows, plan.big_fields))
    for i, (row, f) in enumerate(big):
        mb = plan.bmask[row]
        cand = torch.where(mb > 0, props, dlcat)
        # the exact log-ratio from one synthesis of the move; the residual
        # moves by the move's maps
        dll, du, adu, adu_sp = plan.big_dll(tv, dlcat, cand, u, au, au_sp, f)
        qcorr = (mb * lr_vec).sum(-1)
        acc = log_u[..., row] < dll + qcorr
        dlcat = torch.where(acc[..., None], cand, dlcat)
        ll = torch.where(acc, ll + dll, ll)
        # what a later big block reads: u on its own field, and the maps
        if f in plan.big_fields[i + 1:]:
            u[..., f, :].addcmul_(du[..., f, :], acc.to(dt)[..., None])
        if i + 1 < len(big):
            au = _select(acc, au + adu, au)
            au_sp = _select(acc, None if au_sp is None else au_sp + adu_sp,
                            au_sp)
        res = plan.move_residual(res, acc, adu, adu_sp)
        accs[..., row] = acc.to(dt)

    singles = {"table": _singles_t, "coef": _singles_coef,
               "phi": _singles_phi}[plan.engine]
    dlcat, ll, res, accs = singles(plan, model, grids, t, alpha, beta, props,
                                   lr_vec, log_u, dlcat, ll, res, accs)
    return dlcat, ll, res, accs


def _scan_chunk(ch, G, rho, q_c, alpha, beta, props, lr_vec, log_u, dlcat,
                ll, accs):
    """The m-domain engines' scalar scan over one chunk's bins: everything
    but the cross term sum_{j<k} gacc_j G_kj is fixed at the chunk's start,
    so each step is an addcmul, a compare, a select and a rank-one update
    of the running cross terms c (no host sync).  Returns (dlcat, ll,
    accs, gacc), gacc the accepted moves' gamma (0 where rejected)."""
    gb = ch.gbins
    D = dlcat[..., gb]
    P = props[..., gb]
    sD = torch.sqrt(D)
    gamma = torch.sqrt(P) - sD
    be = beta[..., gb]
    base = (gamma * (alpha[..., gb] - sD * be - rho)
            + 0.5 * gamma * gamma * (q_c - be))
    thr = log_u[..., ch.rows] - lr_vec[..., gb]
    c = torch.zeros_like(base)
    dll_s, acc_s = [], []
    for k in range(gb.shape[0]):
        dll = torch.addcmul(base[..., k], gamma[..., k], c[..., k])
        acc = dll > thr[..., k]
        gk = torch.where(acc, gamma[..., k], 0.0)
        c = torch.addcmul(c, gk[..., None], G[..., :, k])
        dll_s.append(dll)
        acc_s.append(acc)
    dll = torch.stack(dll_s, dim=-1)
    acc = torch.stack(acc_s, dim=-1)
    gacc = torch.where(acc, gamma, 0.0)
    ll = ll + torch.where(acc, dll, 0.0).sum(-1)
    dlcat = dlcat.index_copy(-1, gb, torch.where(acc, P, D))
    accs = accs.index_copy(-1, ch.rows, acc.to(dlcat.dtype))
    return dlcat, ll, accs, gacc


def _singles_t(plan, model, grids, t, alpha, beta, props, lr_vec, log_u,
               dlcat, ll, res, accs):
    """The table-domain singles: per chunk q, G and rho from the ell-pair
    W tables and thin gathered state slices (no per-bin (ring, m) planes),
    the scalar scan, and the fold of the accepted moves into the ring sums
    (Rc, Rs) of the field's map components (and the flat hole residual
    Rp).  Ring phases: the raw ring sums rotate into the unrotated-F
    pairing basis; the Nyquist column (lnyq) contributes through its own
    exact r-resolved path."""
    Rc, Rs, Rp = res
    w1, pos, pwc, pws = plan.w1, plan.pos, plan.pwc, plan.pws
    ph_c, ph_s, nphi = plan.ph_c, plan.ph_s, plan.nphi
    L = model.lmax + 1

    def rot(re, im):
        """(re, im) rotated by the cut rows' phase e^{i m phi0}."""
        if ph_c is None:
            return re, im
        return re * ph_c - im * ph_s, re * ph_s + im * ph_c

    for ch in plan.chunks:
        _kind, gmat, sp, sm = grids[ch.f]
        gsel = gmat[..., ch.j_idx]                          # (..., 2, L, J)
        if ch.lnyq is not None:
            # the Nyquist column's grid entries, (..., J, 1) against the
            # (J, nr) lambda columns
            g_nre = gsel[..., 0, L - 1, :, None]
            g_nim = gsel[..., 1, L - 1, :, None]
            if ph_c is not None:
                pcn, psn = ph_c[:, L - 1], ph_s[:, L - 1]     # (nr,)
        if ch.kind == "s0":
            c0 = ch.comps[0]
            gw = gsel * ch.omega[:, :, None]
            CM = torch.einsum("...cml,...cmk->...mlk", gw, gsel)
            Gl = torch.einsum("...mlk,mlk->...lk", CM, ch.W)
            RcF, RsF = Rc[..., c0, :, :], Rs[..., c0, :, :]
            # the raw ring sums in the pairing basis of the unrotated F
            Rct, Rst = rot(RcF, RsF)
            U0re = torch.einsum("mjr,...rm->...mj", ch.lamA,
                                Rct * w1[:, None])
            U0im = -torch.einsum("mjr,...rm->...mj", ch.lamA,
                                 Rst * w1[:, None])
            rho_l = (torch.einsum("...mj,...mj,m->...j", gsel[..., 0, :, :],
                                  U0re, plan.cmv)
                     + torch.einsum("...mj,...mj,m->...j",
                                    gsel[..., 1, :, :], U0im, plan.cmv))
            if ch.lnyq is not None:
                # the exact Nyquist (m = lmax) term: local cos coefficient
                # Ccn = 2 (Fre c - Fim s), pairing weight pw_cos = nphi,
                # sin column zero
                Fre_n = g_nre * ch.lnyq                     # (..., J, nr)
                Fim_n = g_nim * ch.lnyq
                Ccn = 2.0 * (Fre_n if ph_c is None
                             else Fre_n * pcn - Fim_n * psn)
                Gl = Gl + nphi * torch.einsum("...jr,r,...kr->...jk", Ccn,
                                              w1, Ccn)
                rho_l = rho_l + torch.einsum("...jr,...r->...j", Ccn,
                                             w1 * RcF[..., :, L - 1])
        else:
            cq, cu = ch.comps
            CM = torch.einsum("...cml,...cmk->...mlk", gsel, gsel)
            Gl = torch.einsum("...mlk,mlk->...lk", CM, ch.W)
            wb = w1[:, None]
            RcQ_, RsQ_ = Rc[..., cq, :, :], Rs[..., cq, :, :]
            RcU_, RsU_ = Rc[..., cu, :, :], Rs[..., cu, :, :]
            RcQ, RsQ = rot(RcQ_, RsQ_)
            RcU, RsU = rot(RcU_, RsU_)
            if ch.lnyq is not None:
                # the chunk's local Q / U cos coefficients at m = lmax
                # (pos_lmax = 1)
                lpn, lmn = ch.lnyq
                Are_n = sp * g_nre * lpn + sm * g_nre * lmn
                Aim_n = sp * g_nim * lpn + sm * g_nim * lmn
                Bre_n = sp * g_nre * lpn - sm * g_nre * lmn
                Bim_n = sp * g_nim * lpn - sm * g_nim * lmn
                if ph_c is None:
                    Qcn, Ucn = Are_n, Bim_n
                else:
                    Qcn = Are_n * pcn - Aim_n * psn
                    Ucn = Bre_n * psn + Bim_n * pcn
                Gl = Gl + nphi * (
                    torch.einsum("...jr,r,...kr->...jk", Qcn, w1, Qcn)
                    + torch.einsum("...jr,r,...kr->...jk", Ucn, w1, Ucn))
            Spre = wb * (RcQ + RsU)
            Spim = wb * (RcU - RsQ)
            Smre = wb * (RcQ - RsU)
            Smim = -wb * (RsQ + RcU)
            Upre = torch.einsum("mjr,...rm->...mj", ch.lamA, Spre)
            Upim = torch.einsum("mjr,...rm->...mj", ch.lamA, Spim)
            Umre = torch.einsum("mjr,...rm->...mj", ch.lamB, Smre)
            Umim = torch.einsum("mjr,...rm->...mj", ch.lamB, Smim)
            posj = pos[:, None]
            Xre = sp * Upre + sm * posj * Umre
            Xim = sp * Upim + sm * posj * Umim
            rho_l = ((gsel[..., 0, :, :] * Xre).sum(-2)
                     + (gsel[..., 1, :, :] * Xim).sum(-2))
            if ch.lnyq is not None:
                rho_l = rho_l + (
                    torch.einsum("...jr,...r->...j", Qcn,
                                 w1 * RcQ_[..., :, L - 1])
                    + torch.einsum("...jr,...r->...j", Ucn,
                                   w1 * RcU_[..., :, L - 1]))
        if ch.segj is None:
            G, rho = Gl, rho_l
        else:
            G = ch.segj.T @ Gl @ ch.segj
            rho = rho_l @ ch.segj
        if Rp is not None:
            # hole-point terms on the flat slot axis, the field's map
            # components only: the per-bin values come from the chunk's
            # slot tables and the gathered grid columns, with no per-chain
            # (row, L) planes
            S = plan.spt.nslots
            xs = slice(ch.comps[0] * S, (ch.comps[-1] + 1) * S)
            w_sp = plan.w_sp_flat[xs]
            a_sp = plan.spt.flat_values(gsel, ch.sp_tab, ch.segj,
                                        cm=ch.kind == "s0")
            G = G + torch.einsum("...ix,...jx->...ij", a_sp * w_sp, a_sp)
            rho = rho + torch.einsum("...ix,...x->...i", a_sp,
                                     w_sp * Rp[..., xs])
        q_c = torch.diagonal(G, dim1=-2, dim2=-1)
        dlcat, ll, accs, gacc = _scan_chunk(ch, G, rho, q_c, alpha, beta,
                                            props, lr_vec, log_u, dlcat, ll,
                                            accs)

        # fold the accepted moves into the residual: r <- r - sum_i gamma_i
        # a_i, on the field's map components (in place: the sweep owns the
        # residual)
        gl = gacc if ch.segj is None else gacc @ ch.segj.T
        gg = gsel * gl[..., None, None, :]
        if ch.kind == "s0":
            Fc = torch.einsum("mjr,...cmj->...crm", ch.lamA, gg)
            Fre_u, Fim_u = rot(Fc[..., 0, :, :], Fc[..., 1, :, :])
            Rc[..., c0, :, :] -= (pwc * plan.cmv) * Fre_u
            Rs[..., c0, :, :] += (pws * plan.cmv) * Fim_u
            if ch.lnyq is not None:
                Rc[..., c0, :, L - 1] -= nphi * torch.einsum(
                    "...j,...jr->...r", gl, Ccn)
        else:
            Fp = torch.einsum("mjr,...cmj->...crm", ch.lamA, gg) * sp
            Fm = torch.einsum("mjr,...cmj->...crm", ch.lamB, gg) * sm
            Are, Aim = rot(Fp[..., 0, :, :] + pos * Fm[..., 0, :, :],
                           Fp[..., 1, :, :] + pos * Fm[..., 1, :, :])
            Bre, Bim = rot(Fp[..., 0, :, :] - pos * Fm[..., 0, :, :],
                           Fp[..., 1, :, :] - pos * Fm[..., 1, :, :])
            # (Qc, Qs, Uc, Us) = (Are, -Aim, Bim, Bre)
            Rc[..., cq, :, :] -= pwc * Are
            Rc[..., cu, :, :] -= pwc * Bim
            Rs[..., cq, :, :] += pws * Aim
            Rs[..., cu, :, :] -= pws * Bre
            if ch.lnyq is not None:
                Rc[..., cq, :, L - 1] -= nphi * torch.einsum(
                    "...j,...jr->...r", gl, Qcn)
                Rc[..., cu, :, L - 1] -= nphi * torch.einsum(
                    "...j,...jr->...r", gl, Ucn)
        if Rp is not None:
            Rp[..., xs] -= torch.einsum("...i,...ix->...x", gacc, a_sp)
    return dlcat, ll, (Rc, Rs, Rp), accs


def _chunk_ring_coefs(cut, grids, ch):
    """Ring half-spectrum coefficients of the chunk's per-bin components
    A t_i on the cut rings: (Cc, Cs), each (..., nb, ncomp, nr, L) over the
    field's map components, from the hoisted per-field grids."""
    kind, g, sp, sm = grids[ch.f]
    if kind == "s0":
        Cc, Cs = cut.ring_cs_lsel_spin0_grids(g, ch.j_idx, ch.segj)
        return Cc[..., None, :, :], Cs[..., None, :, :]
    (qc, qs), (uc, us) = cut.ring_cs_lsel_spin2_grids(g, sp, sm, ch.j_idx,
                                                      ch.segj)
    return torch.stack([qc, uc], dim=-3), torch.stack([qs, us], dim=-3)


def _singles_coef(plan, model, grids, t, alpha, beta, props, lr_vec, log_u,
                  dlcat, ll, res, accs):
    """The coefficient m-domain singles (w azimuthally uniform but unequal
    across map components; no sparse split): per chunk the per-bin ring
    half-spectrum coefficients, scaled by sqrt(w pw) once, give G and rho
    as plain products; the scalar scan; the residual's ring sums move by
    the accepted moves' coefficients.  Each chunk's coefficients are
    dropped before the next chunk's are built."""
    Rc, Rs, Rp = res
    cut = model.cut_sht
    for ch in plan.chunks:
        c0, c1 = ch.comps[0], ch.comps[-1] + 1
        Cc, Cs = _chunk_ring_coefs(cut, grids, ch)
        Cc = Cc * ch.sc[0]
        Cs = Cs * ch.sc[1]
        G = (torch.einsum("...icrm,...jcrm->...ij", Cc, Cc)
             + torch.einsum("...icrm,...jcrm->...ij", Cs, Cs))
        q_c = torch.diagonal(G, dim1=-2, dim2=-1)
        # rho_i = <r, a_i>_w = sum (Cc sc_c) (Rc sqrt(w / pw)) + ...
        rho = (torch.einsum("...icrm,...crm->...i", Cc,
                            Rc[..., c0:c1, :, :] * ch.rfac[0])
               + torch.einsum("...icrm,...crm->...i", Cs,
                              Rs[..., c0:c1, :, :] * ch.rfac[1]))
        dlcat, ll, accs, gacc = _scan_chunk(ch, G, rho, q_c, alpha, beta,
                                            props, lr_vec, log_u, dlcat, ll,
                                            accs)
        # Rc(a) = pwc Cc_raw = (Cc sc_c) pwc / sc_c; w = 0 rings feed no
        # w-weighted product downstream, so zeroing them is exact
        Rc[..., c0:c1, :, :] -= torch.einsum("...i,...icrm->...crm", gacc,
                                             Cc) * ch.dfac[0]
        Rs[..., c0:c1, :, :] -= torch.einsum("...i,...icrm->...crm", gacc,
                                             Cs) * ch.dfac[1]
        del Cc, Cs
    return dlcat, ll, (Rc, Rs, Rp), accs


def _chunk_maps(tr, model, f, sel, t):
    """(..., nb, ncomp, *pix) per-bin maps (or point values) A t_i of one
    field-pure chunk through the transform ``tr`` (the cut rows' SHT or the
    hole points' PointSHT), on the field's map components."""
    tf = t[..., f, :]
    if len(_chunk_comps(model, f)) == 1:
        return tr.synthesis_state_lsel(tf, sel)[..., None, :, :]
    z = torch.zeros_like(tf)
    e, b = (tf, z) if f == model._e else (z, tf)
    return torch.stack(tr.synthesis_spin2_state_lsel(e, b, sel), dim=-3)


def _singles_phi(plan, model, grids, t, alpha, beta, props, lr_vec, log_u,
                 dlcat, ll, res, accs):
    """The phi-domain singles (any cut weights): per chunk of at most
    ``_PHI_CHUNK`` bins the per-bin maps A t_i (and hole values A_sp t_i)
    from one ell-selected synthesis, their w-weighted copies and q_i, then
    a scan over the bins that reads the residual (cwr_i = <w r, A t_i>, a
    dot product per chain) and moves it by each accepted bin's map, in
    place.  Each chunk's maps are dropped before the next chunk's are
    built, so that peak memory stays O(chunk)."""
    resid, rp = res
    cut, spt = model.cut_sht, plan.spt
    # per-chain dot products over the (ncomp, nr, ncol) map axes
    dot = lambda a, b: torch.einsum("...crp,...crp->...", a, b)
    for ch in plan.chunks:
        cs = slice(ch.comps[0], ch.comps[-1] + 1)
        maps = [(_chunk_maps(cut, model, ch.f, ch.sel, t), plan.w_cut[cs],
                 resid[..., cs, :, :])]
        if rp is not None:
            maps.append((_chunk_maps(spt, model, ch.f, ch.sel, t),
                         plan.w_sp[cs], rp[..., cs, :, :]))
        # (per-bin maps, their w-weighted copies, the residual's view)
        maps = [(a, w * a, r) for a, w, r in maps]
        q_c = sum(dot(wa, a) for a, wa, _r in maps)
        gb = ch.gbins
        D = dlcat[..., gb]
        P = props[..., gb]
        sD = torch.sqrt(D)
        gamma = torch.sqrt(P) - sD
        al, be = alpha[..., gb], beta[..., gb]
        lu = log_u[..., ch.rows]
        lr = lr_vec[..., gb]
        acc_s = []
        for k in range(gb.shape[0]):
            cwr = sum(dot(wa[..., k, :, :, :], r) for _a, wa, r in maps)
            g_k = gamma[..., k]
            dll = (g_k * (al[..., k] - sD[..., k] * be[..., k] - cwr)
                   + 0.5 * g_k * g_k * (q_c[..., k] - be[..., k]))
            acc = lu[..., k] < dll + lr[..., k]
            gam = torch.where(acc, g_k, 0.0)[..., None, None, None]
            for a, _wa, r in maps:
                r.addcmul_(gam, a[..., k, :, :, :], value=-1.0)
            ll = ll + torch.where(acc, dll, 0.0)
            acc_s.append(acc)
        acc = torch.stack(acc_s, dim=-1)
        dlcat = dlcat.index_copy(-1, gb, torch.where(acc, P, D))
        accs = accs.index_copy(-1, ch.rows, acc.to(dlcat.dtype))
        del maps
    return dlcat, ll, (resid, rp), accs
