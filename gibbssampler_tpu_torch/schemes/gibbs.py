"""Gibbs sampling schemes (PyTorch counterpart of
``gibbssampler_tpu.schemes.gibbs``: centered, non-centered, ASIS and
PNCP).

Chains are the leading axis of every tensor, so one call of ``step``
advances all of them; the iteration loop is a plain Python loop.  Random
numbers come from an explicit ``torch.Generator`` on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..diagnostics import trace
from ..harmonics.gridstate import expand_cl_state, variance_expansion_state
from ..harmonics.spectra import unfold_bins
from ..ops.model import SkyModel
from ..samplers import cls_samplers as cls_mod
from ..samplers import cr as cr_mod

__all__ = ["GibbsState", "GibbsScheme", "CenteredGibbs", "NonCenteredGibbs",
           "ASISGibbs", "PNCPGibbs", "CR_METHODS"]


class GibbsState(NamedTuple):
    s: torch.Tensor       # (nchains, nfields, nstate)
    dl: tuple             # per-field (nchains, nbins_f) binned D_ell


CR_METHODS = ("exact", "cg", "rjpo", "aux_gibbs", "overrelax", "mala", "ula",
              "aux_mala", "pcn")


def _make_cr_step(method: str, model: SkyModel, bt_ninv_d, opts: dict):
    """Bind a CR method name to a (s, var_cls, noise=None, gen=None,
    u=None) -> (s, CRInfo) function, with the JAX package's option names
    and defaults; ``u`` is the MH accept uniform of MALA, RJPO and pCN."""
    n_gibbs = opts.get("n_gibbs", 1)
    tau = opts.get("tau", 0.02)
    maxiter = opts.get("cg_maxiter", 4000)
    if method == "exact":
        return lambda s, var, noise=None, gen=None, u=None: cr_mod.exact_cr(
            model, var, bt_ninv_d, noise=noise, gen=gen)
    if method == "cg":
        return lambda s, var, noise=None, gen=None, u=None: cr_mod.cg_cr(
            model, var, bt_ninv_d, tol=opts.get("cg_tol", 1e-6),
            maxiter=maxiter, noise=noise, gen=gen)
    if method == "rjpo":
        return lambda s, var, noise=None, gen=None, u=None: cr_mod.rjpo_cr(
            model, var, bt_ninv_d, s, tol=opts.get("cg_tol", 1e-5),
            maxiter=maxiter, noise=noise, gen=gen, u=u)
    if method == "aux_gibbs":
        return lambda s, var, noise=None, gen=None, u=None: \
            cr_mod.aux_gibbs_cr(model, var, bt_ninv_d, s, n_gibbs=n_gibbs,
                                noise=noise, gen=gen)
    if method == "overrelax":
        return lambda s, var, noise=None, gen=None, u=None: \
            cr_mod.overrelax_cr(model, var, bt_ninv_d, s,
                                alpha=opts.get("alpha", -0.995),
                                n_gibbs=n_gibbs, noise=noise, gen=gen)
    if method in ("mala", "ula"):
        accept = (True if method == "mala"
                  else opts.get("ula_mh_correct", True))
        return lambda s, var, noise=None, gen=None, u=None: cr_mod.mala_cr(
            model, var, bt_ninv_d, s, tau=tau, accept=accept, noise=noise,
            gen=gen, u=u)
    if method == "aux_mala":
        return lambda s, var, noise=None, gen=None, u=None: \
            cr_mod.aux_then_mala_cr(model, var, bt_ninv_d, s,
                                    n_gibbs=n_gibbs, tau=tau, noise=noise,
                                    gen=gen, u=u)
    if method == "pcn":
        return lambda s, var, noise=None, gen=None, u=None: cr_mod.pcn_cr(
            model, var, bt_ninv_d, s, beta=opts.get("beta", 0.1),
            noise=noise, gen=gen, u=u)
    raise ValueError(f"unknown CR method {method!r}; one of {CR_METHODS}")


def step_span(scheme):
    """Span ``gibbs.step`` of the scheme's next step, its args that step's
    index (``scheme.nsteps``, the steps the scheme has taken before)."""
    i = scheme.nsteps
    scheme.nsteps = i + 1
    return trace.span("gibbs.step", lambda: f"step={i}")


@dataclass
class GibbsScheme:
    """Machinery shared by the schemes: prior variance, initial draw,
    noise pool and the iteration loop."""

    model: SkyModel
    bins_list: Sequence[np.ndarray]
    cr_method: str = "exact"
    cr_options: dict = field(default_factory=dict)

    def __post_init__(self):
        self.bins_list = tuple(np.asarray(b, dtype=np.int64)
                               for b in self.bins_list)
        self.cr_options = dict(self.cr_options)
        self.lmax = self.model.lmax
        self.bt_ninv_d = self.model.bt_ninv_d()
        self._cr_step = _make_cr_step(self.cr_method, self.model,
                                      self.bt_ninv_d, self.cr_options)
        self.nsteps = 0

    @property
    def device(self) -> torch.device:
        return self.model.sht.device

    def var_cls(self, dl_tuple) -> torch.Tensor:
        """(..., nfields, nstate) prior variance from per-field binned D_ell
        (..., nbins_f)."""
        dt = self.model.sht.dtype
        return torch.stack([
            variance_expansion_state(unfold_bins(dl.to(dt), bins, self.lmax),
                                     self.lmax)
            for dl, bins in zip(dl_tuple, self.bins_list)], dim=-2)

    def init_state(self, dl_init_tuple, nchains: int,
                   gen: torch.Generator | None = None) -> GibbsState:
        """Initial CR draw at the starting spectrum, for every chain."""
        m = self.model
        dt = m.sht.dtype
        dl0 = tuple(torch.as_tensor(np.asarray(d), dtype=dt, device=self.device)
                    .expand(nchains, -1).clone() for d in dl_init_tuple)
        s0 = torch.zeros((nchains, m.nfields, m.nstate), dtype=dt,
                         device=self.device)
        s, _ = self._cr_step(s0, self.var_cls(dl0), gen=gen)
        return GibbsState(s=s, dl=dl0)

    @trace.traced("gibbs.draw")
    def draw_noise_pool(self, nchains: int,
                        gen: torch.Generator | None = None) -> dict:
        """Pre-draw the CR step's Gaussian fields for all chains:
        {kind: (nchains, K, *shape)}, kind by kind in the order of
        ``noise_pool_spec``: state, pix (the full grid), aux, sp (the
        hole-point block, for models with the sparse split only)."""
        spec = cr_mod.noise_pool_spec(self.cr_method, self.cr_options)
        m = self.model
        shapes = {"state": (m.nfields, m.nstate),
                  "aux": tuple(m.w_cut.shape) if m.has_cut
                  else tuple(m.noise.tau.shape),
                  "pix": tuple(m.noise.tau.shape)}
        if m.has_sparse:
            shapes["sp"] = tuple(m.w_sp.shape)
        return {kind: torch.randn((nchains, k) + shapes[kind], generator=gen,
                                  dtype=m.sht.dtype, device=self.device)
                for kind, k in spec.items() if kind in shapes}

    def step(self, state: GibbsState, noise=None, gen=None, u=None,
             gammas=None):
        raise NotImplementedError

    def run(self, dl_init_tuple, n_iter: int, nchains: int = 1,
            gen: torch.Generator | None = None,
            state: GibbsState | None = None) -> dict:
        """Run ``nchains`` chains for ``n_iter`` iterations, starting with
        the initial CR draw (or from ``state``).

        Returns per-field D_ell chains (nchains, n_iter, nbins_f), the CR
        accept history (nchains, n_iter), for a scheme with an MH step the
        per-field block accept history ``mh_accept`` (nchains, n_iter,
        nblocks_f), and the final state."""
        if state is None:
            state = self.init_state(dl_init_tuple, nchains, gen)
        nchains = state.s.shape[0]
        infos = []
        for _ in range(n_iter):
            pool = self.draw_noise_pool(nchains, gen)
            state, info = self.step(state, noise=pool, gen=gen)
            infos.append(info)
        nf = len(self.bins_list)
        out = {
            "dl_chains": tuple(torch.stack([i["dl"][f] for i in infos], dim=1)
                               for f in range(nf)),
            "cr_accept": torch.stack([i["cr_accept"] for i in infos], dim=1),
            "final_state": state,
        }
        if infos and "mh_accept" in infos[0]:
            out["mh_accept"] = tuple(
                torch.stack([i["mh_accept"][f] for i in infos], dim=1)
                for f in range(nf))
        return out


class CenteredGibbs(GibbsScheme):
    """CR step + conjugate inverse-gamma C_ell step."""

    def step(self, state: GibbsState, noise=None, gen=None, u=None,
             gammas=None):
        """One iteration of every chain.  ``noise``: this iteration's pool;
        ``u``: MALA accept uniforms (nchains,); ``gammas``: per-field gamma
        variates (nchains, nbins_f).  Whatever is not injected is drawn
        from ``gen``."""
        with step_span(self):
            with trace.span("gibbs.cr"):
                s, cr_info = self._cr_step(state.s, self.var_cls(state.dl),
                                           noise, gen, u)
            with trace.span("gibbs.cls"):
                dl = cls_mod.centered_cls_sample(s, self.bins_list,
                                                 self.lmax, gammas=gammas,
                                                 gen=gen)
        return GibbsState(s=s, dl=dl), {"dl": dl,
                                        "cr_accept": cr_info.accept}


def _cut_mh_eligible(model, blocks_list, all_sph: bool) -> bool:
    """True when the rank-one blocked-MH fast path applies: cut model,
    pixel-domain likelihood, at least one single-bin block, and every
    multi-bin block preceding the single-bin ones."""
    if not getattr(model, "has_cut", False) or all_sph:
        return False
    kinds = [hi - lo == 1 for blocks in blocks_list for (lo, hi) in blocks]
    if not any(kinds):
        return False
    first_single = kinds.index(True)
    return all(kinds[first_single:])


MH_FAST = ("auto", "phi", "off")


class _BlockedMHGibbs(GibbsScheme):
    """Machinery of the schemes with a non-centered blocked-MH D_ell step
    (non-centered, ASIS, PNCP): the blocks, the proposal scales and the
    engines.

    ``mh_fast``: "auto" takes the rank-one fast path (``nc_cls_sample_cut``)
    when ``_cut_mh_eligible`` holds, on the engine ``CutMHPlan`` picks for
    the model (table domain, coefficient m domain or phi domain, as the JAX
    package picks); "phi" takes the fast path pinned to the phi-domain
    engine (``mdomain=False``); "off" the direct ``nc_cls_sample`` on
    ``log_like``.  The engine's static tables are built once, here."""

    def __init__(self, model, bins_list, blocks_list, prop_sigma_list,
                 n_iter_mh: int = 1, all_sph: bool = False, d_alm=None,
                 mh_fast: str = "auto", l_cut_identity=None, **kw):
        super().__init__(model, bins_list, **kw)
        if mh_fast not in MH_FAST:
            raise ValueError(f"mh_fast={mh_fast!r}; one of {MH_FAST}")
        self.blocks_list = tuple(tuple((int(lo), int(hi)) for lo, hi in bl)
                                 for bl in blocks_list)
        self.mh_plan = None
        self.prop_sigma_list = prop_sigma_list
        self.n_iter_mh = n_iter_mh
        self.all_sph = all_sph
        self.mh_fast = mh_fast
        self.log_like = self._log_like(all_sph, d_alm)
        self._use_cut_mh = (mh_fast != "off"
                            and _cut_mh_eligible(model, self.blocks_list,
                                                 all_sph))
        self.mh_plan = (cls_mod.CutMHPlan(model, self.bins_list,
                                          self.blocks_list,
                                          self.prop_sigma_list,
                                          mdomain=mh_fast != "phi",
                                          l_cut_identity=l_cut_identity)
                        if self._use_cut_mh else None)

    def _log_like(self, all_sph, d_alm):
        """The direct engine's likelihood."""
        return cls_mod.make_nc_log_likelihood(self.model, self.bins_list,
                                              all_sph=all_sph, d_alm=d_alm)

    @property
    def prop_sigma_list(self) -> tuple:
        """Per-field (nbins_f,) proposal std devs of the MH step; assigning
        it goes through ``set_proposal_sigmas``."""
        return self._prop_sigma_list

    @prop_sigma_list.setter
    def prop_sigma_list(self, sig_list):
        self.set_proposal_sigmas(sig_list)

    def set_proposal_sigmas(self, sig_list):
        """Swap the proposal scales of both MH engines: ``prop_sigma_list``
        and, in place, the fast path plan's ``sigma``.  The plan and its
        tables stay as they are (nothing is rebuilt)."""
        if len(sig_list) != len(self.bins_list):
            raise ValueError(f"{len(sig_list)} proposal scale vectors for "
                             f"{len(self.bins_list)} fields")
        sig = tuple(np.array(np.broadcast_to(np.asarray(p, dtype=np.float64),
                                             (len(b) - 1,)))
                    for p, b in zip(sig_list, self.bins_list))
        self._prop_sigma_list = sig
        if self.mh_plan is not None:
            self.mh_plan.set_sigma(sig)

    @trace.traced("cls.mh")
    def mh_step(self, dl, s_nc, u_prop=None, u_acc=None, gen=None):
        """The blocked-MH D_ell step given the whitened map: the fast path
        on the plan's engine when eligible, else the direct evaluation."""
        if self._use_cut_mh:
            return cls_mod.nc_cls_sample_cut(
                dl, s_nc, self.model, self.bins_list, self.blocks_list,
                self.prop_sigma_list, n_iter=self.n_iter_mh, u_prop=u_prop,
                u_acc=u_acc, gen=gen, plan=self.mh_plan)
        return cls_mod.nc_cls_sample(
            dl, s_nc, self.log_like, self.bins_list, self.blocks_list,
            self.prop_sigma_list, n_iter=self.n_iter_mh, u_prop=u_prop,
            u_acc=u_acc, gen=gen)


class NonCenteredGibbs(_BlockedMHGibbs):
    """CR step re-expressed non-centered + blocked-MH D_ell step: recenter
    -> CR -> whiten -> blocked MH.  State.s holds the whitened map s_nc.
    ``all_sph`` takes the harmonic likelihood on the full sky (``d_alm``,
    the data's alm), which the fast path does not run."""

    def init_state(self, dl_init_tuple, nchains: int,
                   gen: torch.Generator | None = None) -> GibbsState:
        st = super().init_state(dl_init_tuple, nchains, gen)
        return GibbsState(s=cls_mod.whiten(st.s, st.dl, self.bins_list,
                                           self.lmax), dl=st.dl)

    def step(self, state: GibbsState, noise=None, gen=None, u=None,
             u_prop=None, u_acc=None):
        """One iteration of every chain.  Injectable variates as in
        ``ASISGibbs.step`` (no gamma variates: no conjugate draw)."""
        with step_span(self):
            s = cls_mod.recenter(state.s, state.dl, self.bins_list,
                                 self.lmax)
            with trace.span("gibbs.cr"):
                s, cr_info = self._cr_step(s, self.var_cls(state.dl), noise,
                                           gen, u)
            with trace.span("gibbs.cls"):
                s_nc = cls_mod.whiten(s, state.dl, self.bins_list,
                                      self.lmax)
                dl, mh_info = self.mh_step(state.dl, s_nc, u_prop=u_prop,
                                           u_acc=u_acc, gen=gen)
        return GibbsState(s=s_nc, dl=dl), {"dl": dl,
                                           "cr_accept": cr_info.accept,
                                           "mh_accept": mh_info.accept}


class ASISGibbs(_BlockedMHGibbs):
    """Ancillarity-sufficiency interweaving: centered CR -> centered
    inverse-gamma draw -> whiten -> non-centered blocked-MH D_ell draw ->
    recenter.  State.s holds the centered map."""

    def step(self, state: GibbsState, noise=None, gen=None, u=None,
             gammas=None, u_prop=None, u_acc=None):
        """One iteration of every chain.  Injectable variates as in
        ``CenteredGibbs.step``, plus the MH step's ``u_prop`` (nchains,
        n_iter_mh, nbins_total) and ``u_acc`` (nchains, n_iter_mh,
        nblocks) uniforms."""
        with step_span(self):
            with trace.span("gibbs.cr"):
                s, cr_info = self._cr_step(state.s, self.var_cls(state.dl),
                                           noise, gen, u)
            with trace.span("gibbs.cls"):
                dl_c = cls_mod.centered_cls_sample(s, self.bins_list,
                                                   self.lmax, gammas=gammas,
                                                   gen=gen)
                s_nc = cls_mod.whiten(s, dl_c, self.bins_list, self.lmax)
                dl, mh_info = self.mh_step(dl_c, s_nc, u_prop=u_prop,
                                           u_acc=u_acc, gen=gen)
                s = cls_mod.recenter(s_nc, dl, self.bins_list, self.lmax)
        return GibbsState(s=s, dl=dl), {"dl": dl,
                                        "cr_accept": cr_info.accept,
                                        "mh_accept": mh_info.accept}


class PNCPGibbs(_BlockedMHGibbs):
    """Partially non-centered parametrization: the multipoles below l_cut
    sampled centered (the conjugate inverse-gamma draw), those above
    non-centered (blocked MH).

    ``l_cut``: one int, or one value per field (a sequence or an ndarray);
    each must be a bin boundary of its field (ValueError otherwise).  A
    field whose l_cut is its last bin edge is sampled fully centered (no
    MH block).  Only the blocks at or above each field's cut bin are kept.
    The fast path runs with the identity re-centering below l_cut
    (``CutMHPlan(l_cut_identity=l_cut)``); the direct path (``mh_fast=
    "off"``, or a model without the cut decomposition) on a likelihood of
    the same kind with the prior variance ``_var_high``."""

    def __init__(self, model, bins_list, blocks_list, prop_sigma_list,
                 l_cut, n_iter_mh: int = 1, all_sph: bool = False,
                 mh_fast: str = "auto", **kw):
        bins = [np.asarray(b, dtype=np.int64) for b in bins_list]
        lcs = (tuple(int(c) for c in l_cut) if np.ndim(l_cut)
               else (int(l_cut),) * len(bins))
        if len(lcs) != len(bins):
            raise ValueError(f"l_cut={l_cut}: need one value or one per "
                             f"field ({len(bins)})")
        cut_bin = []
        for b, lc in zip(bins, lcs):
            if lc not in list(b):
                raise ValueError(
                    f"l_cut={lc} must be a bin boundary (got bins={b})")
            cut_bin.append(int(np.searchsorted(b, lc)))
        self.l_cut = lcs
        self.cut_bin = tuple(cut_bin)
        blocks = [[(lo, hi) for (lo, hi) in bl if lo >= cb]
                  for bl, cb in zip(blocks_list, self.cut_bin)]
        super().__init__(model, bins_list, blocks, prop_sigma_list,
                         n_iter_mh=n_iter_mh, all_sph=all_sph,
                         mh_fast=mh_fast, l_cut_identity=lcs, **kw)
        # (nfields, nstate) True on the slots with l < l_cut
        low = np.stack([np.arange(self.lmax + 1) < lc for lc in lcs])
        self._low = expand_cl_state(torch.as_tensor(
            low, dtype=model.sht.dtype, device=self.device), self.lmax) > 0

    def _log_like(self, all_sph, d_alm):
        return cls_mod.NCLogLike(self.model, self.bins_list,
                                 "cut" if self.model.has_cut else "pix",
                                 var_fn=self._var_high)

    def _var_high(self, dl_tuple, dtype):
        """Prior variance with 1 on the valid l < l_cut slots (identity
        re-centering; invalid layout slots keep variance 0), one low-ell
        mask row per field."""
        var = cls_mod._dl_tuple_to_var(dl_tuple, self.bins_list, self.lmax,
                                       dtype)
        return torch.where(self._low, 1.0, var)

    def step(self, state: GibbsState, noise=None, gen=None, u=None,
             gammas=None, u_prop=None, u_acc=None):
        """One iteration of every chain: centered CR, the conjugate draw
        kept below each field's cut bin, whiten the high multipoles,
        blocked MH, recenter.  Injectable variates as in
        ``ASISGibbs.step``."""
        with step_span(self):
            with trace.span("gibbs.cr"):
                s, cr_info = self._cr_step(state.s, self.var_cls(state.dl),
                                           noise, gen, u)
            with trace.span("gibbs.cls"):
                dl_c = cls_mod.centered_cls_sample(s, self.bins_list,
                                                   self.lmax, gammas=gammas,
                                                   gen=gen)
                dl = tuple(torch.where(torch.arange(d.shape[-1],
                                                    device=d.device)
                                       < cb, d, old)
                           for d, old, cb in zip(dl_c, state.dl,
                                                 self.cut_bin))
                with trace.span("cls.whiten"):
                    var_h = self._var_high(dl, s.dtype)
                    s_pnc = s * torch.where(var_h > 0, 1.0 / torch.sqrt(
                        torch.where(var_h > 0, var_h, 1.0)), 0.0)
                dl, mh_info = self.mh_step(dl, s_pnc, u_prop=u_prop,
                                           u_acc=u_acc, gen=gen)
                with trace.span("cls.recenter"):
                    s = torch.sqrt(self._var_high(dl, s.dtype)) * s_pnc
        return GibbsState(s=s, dl=dl), {"dl": dl,
                                        "cr_accept": cr_info.accept,
                                        "mh_accept": mh_info.accept}
