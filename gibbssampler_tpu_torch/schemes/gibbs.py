"""Gibbs sampling schemes (PyTorch counterpart of
``gibbssampler_tpu.schemes.gibbs``: the centered scheme).

Chains are the leading axis of every tensor, so one call of ``step``
advances all of them; the iteration loop is a plain Python loop.  Random
numbers come from an explicit ``torch.Generator`` on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..harmonics.gridstate import variance_expansion_state
from ..harmonics.spectra import unfold_bins
from ..ops.model import SkyModel
from ..samplers import cls_samplers as cls_mod
from ..samplers import cr as cr_mod

__all__ = ["GibbsState", "GibbsScheme", "CenteredGibbs", "CR_METHODS"]


class GibbsState(NamedTuple):
    s: torch.Tensor       # (nchains, nfields, nstate)
    dl: tuple             # per-field (nchains, nbins_f) binned D_ell


CR_METHODS = ("exact", "aux_mala")


def _make_cr_step(method: str, model: SkyModel, bt_ninv_d, opts: dict):
    """Bind a CR method name to a (s, var_cls, noise=None, gen=None,
    u=None) -> (s, CRInfo) function; ``u`` is the MALA accept uniform."""
    if method == "exact":
        return lambda s, var, noise=None, gen=None, u=None: cr_mod.exact_cr(
            model, var, bt_ninv_d, noise=noise, gen=gen)
    if method == "aux_mala":
        return lambda s, var, noise=None, gen=None, u=None: \
            cr_mod.aux_then_mala_cr(
                model, var, bt_ninv_d, s, n_gibbs=opts.get("n_gibbs", 1),
                tau=opts.get("tau", 0.02), noise=noise, gen=gen, u=u)
    raise ValueError(f"unknown CR method {method!r}; one of {CR_METHODS}")


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

    def draw_noise_pool(self, nchains: int,
                        gen: torch.Generator | None = None) -> dict:
        """Pre-draw the CR step's Gaussian fields for all chains:
        {kind: (nchains, K, *shape)}."""
        spec = cr_mod.noise_pool_spec(self.cr_method, self.cr_options)
        m = self.model
        shapes = {"state": (m.nfields, m.nstate),
                  "aux": tuple(m.w_cut.shape) if m.has_cut
                  else tuple(m.noise.tau.shape)}
        return {kind: torch.randn((nchains, k) + shapes[kind], generator=gen,
                                  dtype=m.sht.dtype, device=self.device)
                for kind, k in spec.items()}

    def step(self, state: GibbsState, noise=None, gen=None, u=None,
             gammas=None):
        raise NotImplementedError

    def run(self, dl_init_tuple, n_iter: int, nchains: int = 1,
            gen: torch.Generator | None = None,
            state: GibbsState | None = None) -> dict:
        """Run ``nchains`` chains for ``n_iter`` iterations, starting with
        the initial CR draw (or from ``state``).

        Returns per-field D_ell chains (nchains, n_iter, nbins_f), the CR
        accept history (nchains, n_iter) and the final state."""
        if state is None:
            state = self.init_state(dl_init_tuple, nchains, gen)
        nchains = state.s.shape[0]
        dls, accs = [], []
        for _ in range(n_iter):
            pool = self.draw_noise_pool(nchains, gen)
            state, info = self.step(state, noise=pool, gen=gen)
            dls.append(info["dl"])
            accs.append(info["cr_accept"])
        return {
            "dl_chains": tuple(torch.stack([d[f] for d in dls], dim=1)
                               for f in range(len(self.bins_list))),
            "cr_accept": torch.stack(accs, dim=1),
            "final_state": state,
        }


class CenteredGibbs(GibbsScheme):
    """CR step + conjugate inverse-gamma C_ell step."""

    def step(self, state: GibbsState, noise=None, gen=None, u=None,
             gammas=None):
        """One iteration of every chain.  ``noise``: this iteration's pool;
        ``u``: MALA accept uniforms (nchains,); ``gammas``: per-field gamma
        variates (nchains, nbins_f).  Whatever is not injected is drawn
        from ``gen``."""
        s, cr_info = self._cr_step(state.s, self.var_cls(state.dl), noise,
                                   gen, u)
        dl = cls_mod.centered_cls_sample(s, self.bins_list, self.lmax,
                                         gammas=gammas, gen=gen)
        return GibbsState(s=s, dl=dl), {"dl": dl,
                                        "cr_accept": cr_info.accept}
