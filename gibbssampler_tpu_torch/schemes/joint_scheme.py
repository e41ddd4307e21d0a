"""Joint correlated-field Gibbs scheme, TT/TE/EE[/BB] (PyTorch counterpart
of ``gibbssampler_tpu.schemes.joint_scheme``).

One iteration: the joint CR draw of (T, E, B) given the C_ell blocks, then
the conjugate per-ell inverse-Wishart draw of the blocks given the fields.
Chains are the leading axis of every tensor; random numbers come from an
explicit ``torch.Generator`` or are injected.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..diagnostics import trace
from ..samplers.cls_samplers import invwishart_cls_sample
from ..samplers.joint import blocks_to_dl, cg_joint_cr, exact_joint_cr
from .gibbs import step_span

__all__ = ["JointState", "JointCenteredGibbs"]


class JointState(NamedTuple):
    s: torch.Tensor       # (nchains, k, nstate)
    cl: torch.Tensor      # (nchains, lmax+1, k, k) C_ell blocks


class JointCenteredGibbs:
    """Centered Gibbs over per-ell covariance blocks of k correlated fields.

    cr_method: "exact" (the full-sky per-slot solve) or "cg" (the masked-sky
    block-preconditioned CG, options ``cg_tol`` (1e-6) and ``cg_maxiter``
    (4000)).  The data term B A^T N^-1 d is computed once, here."""

    def __init__(self, model, lmin: int = 2, cr_method: str = "exact",
                 cr_options: dict | None = None):
        if cr_method not in ("exact", "cg"):
            raise ValueError(f"joint cr_method must be exact|cg, got "
                             f"{cr_method!r}")
        self.model = model
        self.lmin = lmin
        self.lmax = model.lmax
        self.cr_method = cr_method
        self.cr_options = dict(cr_options or {})
        self.bt_ninv_d = model.bt_ninv_d()
        self.nsteps = 0

    @property
    def device(self) -> torch.device:
        return self.model.sht.device

    def _cr(self, cl, noise=None, gen=None):
        """The CR draw at blocks ``cl`` (nchains, lmax+1, k, k).  ``noise``:
        optional injected variates, {"xi": (nchains, k, nstate)} for the
        exact draw, {"om0": ..., "om1": ...} for CG."""
        noise = noise or {}
        if self.cr_method == "cg":
            return cg_joint_cr(self.model, cl, self.bt_ninv_d,
                               tol=self.cr_options.get("cg_tol", 1e-6),
                               maxiter=self.cr_options.get("cg_maxiter", 4000),
                               om0=noise.get("om0"), om1=noise.get("om1"),
                               gen=gen)
        return exact_joint_cr(self.model, cl, self.bt_ninv_d,
                              xi=noise.get("xi"), gen=gen)

    def init_state(self, cl_init, nchains: int,
                   gen: torch.Generator | None = None) -> JointState:
        """Initial CR draw at the starting blocks, for every chain."""
        cl0 = (torch.as_tensor(np.asarray(cl_init), dtype=self.model.sht.dtype,
                               device=self.device)
               .expand(nchains, -1, -1, -1).clone())
        s, _ = self._cr(cl0, gen=gen)
        return JointState(s=s, cl=cl0)

    def step(self, state: JointState, noise=None, gen=None, chi2=None,
             normals=None):
        """One iteration of every chain.  ``noise``: the CR variates as in
        ``_cr``; ``chi2`` / ``normals``: the inverse-Wishart draw's
        variates.  Whatever is not injected is drawn from ``gen``."""
        with step_span(self):
            with trace.span("gibbs.cr"):
                s, cr_info = self._cr(state.cl, noise, gen)
            with trace.span("gibbs.cls"):
                cl = invwishart_cls_sample(s, self.lmax, lmin=self.lmin,
                                           chi2=chi2, normals=normals,
                                           gen=gen)
        return JointState(s=s, cl=cl), {"dl": (blocks_to_dl(cl, self.lmax),),
                                        "cr_accept": cr_info.accept}

    def check_cl_init(self, cl_init):
        """Validate the initial blocks: a non-SPD block would make the
        per-slot Cholesky NaN."""
        ev = np.linalg.eigvalsh(np.asarray(cl_init)[self.lmin:])
        if not (ev >= -1e-12 * max(1.0, float(np.abs(ev).max()))).all():
            raise ValueError(
                "cl_init has non-positive-semidefinite blocks (e.g. |TE| > "
                "sqrt(TT*EE)); min eigenvalue "
                f"{float(ev.min()):.3e} at l>={self.lmin}")

    def run(self, cl_init, n_iter: int, nchains: int = 1,
            gen: torch.Generator | None = None,
            state: JointState | None = None) -> dict:
        """Run ``nchains`` chains for ``n_iter`` iterations from the initial
        CR draw at ``cl_init`` (checked first), or from ``state``.  Returns
        the D_ell block chain ``dl_chains`` (one entry, (nchains, n_iter,
        lmax+1, k, k)), the CR accept history (nchains, n_iter) and the
        final state."""
        if state is None:
            self.check_cl_init(cl_init)
            state = self.init_state(cl_init, nchains, gen)
        infos = []
        for _ in range(n_iter):
            state, info = self.step(state, gen=gen)
            infos.append(info)
        return {"dl_chains": (torch.stack([i["dl"][0] for i in infos],
                                          dim=1),),
                "cr_accept": torch.stack([i["cr_accept"] for i in infos],
                                         dim=1),
                "final_state": state}
