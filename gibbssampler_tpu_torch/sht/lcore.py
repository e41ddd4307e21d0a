"""Legendre-stage core of the transforms (PyTorch counterpart of
``gibbssampler_tpu.sht.lcore``, dense-table path).

The latitude stage is a per-m contraction between the triangular
(m, l, ring) operator tables and (..., m, l) alm grids.  Each table is one
dense (L, L, nr) tensor on the device; the kernels of
``sht.legendre_kernels`` skip its zero triangle (l < m) themselves, which
replaces the JAX package's 128-wide m-block wedge slices.  The
``_lsynth_stack`` / ``_ladj_stack`` pair below is the only route to the
Legendre stage: it folds every leading axis (chains, fields, re/im) into the
kernels' batch axis C.  ``lsel_table`` is the only read of a table by ell
(``_lsel_F`` and the blocked-MH engines' tables go through it); an
m-sharded copy (``parallel.shard_sht``) overrides these three.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..harmonics.gridstate import flat_to_state, state_masks, state_to_flat
from .legendre_kernels import legendre_adj_tri, legendre_synth_tri

__all__ = ["FlatAlmMethods", "LegendreCore"]


class LegendreCore:
    """Mixin holding the Legendre contraction and the state packing."""

    def _init_core(self, lmax: int, dtype, device):
        self.lmax = lmax
        self.dtype = dtype
        self.device = torch.device(device)
        sm = state_masks(lmax)
        self.pack_in = torch.as_tensor(sm.in_scale, dtype=dtype,
                                       device=self.device)
        self.pack_out = torch.as_tensor(sm.out_scale, dtype=dtype,
                                        device=self.device)
        # (2 - delta_m0) and (1 - delta_m0) weights of the real series
        m = np.arange(lmax + 1)
        self.cm = torch.as_tensor(np.where(m == 0, 1.0, 2.0), dtype=dtype,
                                  device=self.device)
        self.pos = torch.as_tensor(np.where(m == 0, 0.0, 1.0), dtype=dtype,
                                   device=self.device)

    def _table(self, tab) -> torch.Tensor:
        """fp64 numpy (L, L, nr) table -> contiguous device tensor."""
        return torch.as_tensor(tab, dtype=self.dtype,
                               device=self.device).contiguous()

    def lsel_table(self, lam: torch.Tensor, j_idx) -> torch.Tensor:
        """The (L, J, nr) slice of a dense (L, L, nr) table at the selected
        ells ``j_idx`` (a host array or a tensor; zero where m > ell, as
        the table itself is)."""
        if not isinstance(j_idx, torch.Tensor):
            j_idx = torch.as_tensor(np.asarray(j_idx, dtype=np.int64))
        return lam[:, j_idx.to(lam.device), :]

    # -- state <-> grid packing (reshape + diagonal scale) -----------------

    def _state_grids(self, x: torch.Tensor) -> torch.Tensor:
        """Grid-packed state (..., nstate) -> scaled (..., 2, L, L) grids."""
        L = self.lmax + 1
        g = x.reshape(x.shape[:-1] + (2, L, L)).to(self.dtype)
        return g * self.pack_in

    def _grids_to_state(self, g2: torch.Tensor) -> torch.Tensor:
        """Stacked (..., 2, L, L) true Re/Im grids -> grid-packed state."""
        L = self.lmax + 1
        return (g2 * self.pack_out).reshape(g2.shape[:-3] + (2 * L * L,))

    # -- contraction cores -------------------------------------------------

    def _lsynth_stack(self, lam: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
        """(..., c, L, L) [.., m, l] grids -> F (..., c, nr, L) [.., r, m]."""
        L = self.lmax + 1
        batch = g2.shape[:-2]
        C = math.prod(batch)
        x = g2.reshape(C, L, L).transpose(0, 1)     # (m, C, l) view, no copy
        out = legendre_synth_tri(lam, x)            # (m, nr, C)
        nr = out.shape[1]
        return out.permute(2, 1, 0).reshape(batch + (nr, L))

    def _lsel_F(self, lam: torch.Tensor, g2: torch.Tensor, j_idx,
                seg=None) -> torch.Tensor:
        """Per-bin Legendre synthesis by an ell gather: (..., c, L, L)
        grids, the selected ells ``j_idx`` (J,) and the (J, nb) segment
        matrix ``seg`` (None when every bin is one ell, the J ells being
        the bins; either a host array or a tensor) -> (..., nb, c, nr, L)
        ring Fourier coefficients of each bin, contiguous.  Each selected
        ell costs one table gather and a product: O(J/L) of a dense
        contraction over l with a one-hot selector.  The product is formed
        in the output's layout (the (J, nr, m) table slice and the (..., J,
        c, m) grid columns are small), so the large tensor is written once,
        contiguously, and the bins' segment sums are one matrix product
        over J."""
        if not isinstance(j_idx, torch.Tensor):
            j_idx = torch.as_tensor(np.asarray(j_idx, dtype=np.int64))
        idx = j_idx.to(g2.device)
        # (J, r, m)
        lamj = self.lsel_table(lam, idx).permute(1, 2, 0).contiguous()
        gj = g2.to(lam.dtype)[..., idx].movedim(-1, -3)        # (..., J, c, m)
        # (..., J, c, 1, m) * (J, 1, r, m) -> (..., J, c, r, m)
        prod = gj.unsqueeze(-2) * lamj.unsqueeze(-3)
        if seg is None:
            return prod.to(self.dtype)
        if not isinstance(seg, torch.Tensor):
            seg = torch.as_tensor(np.asarray(seg))
        seg = seg.to(dtype=prod.dtype, device=prod.device)
        J = prod.shape[-4]
        out = torch.matmul(seg.T, prod.reshape(prod.shape[:-4] + (J, -1)))
        return out.reshape(out.shape[:-1] + prod.shape[-3:]).to(self.dtype)

    def _lsynth_stack_binned(self, lam: torch.Tensor, g2: torch.Tensor,
                             sel) -> torch.Tensor:
        """Segmented Legendre synthesis: (..., c, L, L) grids and an (nb, L)
        ell selector ``sel`` (host array) -> (..., nb, c, nr, L), bin b's
        coefficients being those of the ells that row b of ``sel`` picks,
        weighted by its entries.  The same function as the one-hot
        contraction sum_l lam[m, l, r] sel[b, l] g[..., c, m, l], computed
        through ``_lsel_F``: the selected (b, l) pairs become the gathered
        ells and their segment matrix, so no (..., b, m, l) or (b, m, l, r)
        intermediate is formed."""
        sel = np.asarray(sel.detach().cpu() if isinstance(sel, torch.Tensor)
                         else sel, dtype=np.float64)
        bs, ls = np.nonzero(sel)                       # bin-major order
        seg = np.zeros((ls.size, sel.shape[0]))
        seg[np.arange(ls.size), bs] = sel[bs, ls]
        return self._lsel_F(lam, g2, ls, seg)

    def _ladj_stack(self, lam: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """(..., c, nr, L) [.., r, m] ring grids -> (..., c, L, L) alm grids,
        contiguous."""
        L = self.lmax + 1
        batch = g.shape[:-2]
        nr = g.shape[-2]
        C = math.prod(batch)
        # one copy into (m, C, r) order, passed as the (m, r, C) view
        gk = g.reshape(C, nr, L).permute(2, 0, 1).contiguous().transpose(1, 2)
        out = legendre_adj_tri(lam, gk)   # (m, C, l) view of a (C, m, l) tensor
        return out.transpose(0, 1).reshape(batch + (L, L))

    def _ladj2(self, lam, Gre, Gim):
        """(Gre, Gim) (..., nr, L) -> (are, aim) (..., L, L) grids."""
        a = self._ladj_stack(lam, torch.stack([Gre, Gim], dim=-3))
        return a[..., 0, :, :], a[..., 1, :, :]

    # -- spin-2 Legendre stages --------------------------------------------

    def _spin2_stacks(self, e_state, b_state):
        """(ap, am) Legendre-stage input stacks of a+ = -(E + iB),
        a- = -(E - iB)."""
        eg = self._state_grids(e_state)
        bg = self._state_grids(b_state)
        ere, eim = eg[..., 0, :, :], eg[..., 1, :, :]
        bre, bim = bg[..., 0, :, :], bg[..., 1, :, :]
        ap = torch.stack([-(ere - bim), -(eim + bre)], dim=-3)
        am = torch.stack([-(ere + bim), -(eim - bre)], dim=-3)
        return ap, am

    def _spin2_F_stacks(self, ap, am):
        """(ap, am) stacks -> (Fp_re, Fp_im, Fm_re, Fm_im) through the
        spin-2 tables."""
        Fp = self._lsynth_stack(self.lam_p2, ap)
        Fm = self._lsynth_stack(self.lam_m2, am)
        return (Fp[..., 0, :, :], Fp[..., 1, :, :],
                Fm[..., 0, :, :], Fm[..., 1, :, :])

    def _spin2_F(self, e_state, b_state):
        """(E, B) grid-packed states -> (Fp_re, Fp_im, Fm_re, Fm_im) ring
        Fourier coefficients of a+ through lam+2 and a- through lam-2."""
        return self._spin2_F_stacks(*self._spin2_stacks(e_state, b_state))

    def _spin2_agrids(self, Cp_re, Cp_im, Cm_re, Cm_im):
        """Ring coefficients -> (ap_re, ap_im, am_re, am_im) alm grids (the
        Legendre adjoint of ``_spin2_F``; C- enters conjugated)."""
        ap_re, ap_im = self._ladj2(self.lam_p2, Cp_re, Cp_im)
        am_re, am_im = self._ladj2(self.lam_m2, Cm_re, -Cm_im)
        return ap_re, ap_im, am_re, am_im

    def _spin2_recombine(self, ap_re, ap_im, am_re, am_im):
        """(a+, a-) grids -> (E, B) grid-packed states:
        E = -(a+ + a-)/2, B = i (a+ - a-)/2."""
        e_re, e_im = -0.5 * (ap_re + am_re), -0.5 * (ap_im + am_im)
        b_re, b_im = -0.5 * (ap_im - am_im), 0.5 * (ap_re - am_re)
        return (self._grids_to_state(torch.stack([e_re, e_im], dim=-3)),
                self._grids_to_state(torch.stack([b_re, b_im], dim=-3)))

    def _spin2_alm(self, Cp_re, Cp_im, Cm_re, Cm_im):
        """Ring Fourier coefficients C+ = sum (Q+iU) e^{-im phi},
        C- = sum (Q+iU) e^{+im phi} -> (E, B) grid-packed states."""
        return self._spin2_recombine(
            *self._spin2_agrids(Cp_re, Cp_im, Cm_re, Cm_im))


class FlatAlmMethods:
    """The transforms on the real (flat) alm packing, each a wrapper of the
    grid-packed state method of the same name (``flat_to_state`` /
    ``state_to_flat`` at the boundary)."""

    def synthesis(self, flat: torch.Tensor) -> torch.Tensor:
        """A on the real alm packing (..., (lmax+1)^2) -> maps."""
        return self.synthesis_state(flat_to_state(flat.to(self.dtype),
                                                  self.lmax))

    def analysis(self, maps: torch.Tensor) -> torch.Tensor:
        """Maps -> the real alm packing (healpy's map2alm role): the exact
        inverse of ``synthesis`` on a quadrature grid, the pixel-area
        scaled adjoint on HEALPix."""
        return state_to_flat(self.analysis_state(maps), self.lmax)

    def adjoint_synthesis(self, maps: torch.Tensor) -> torch.Tensor:
        """A^T: exact transpose of ``synthesis`` with respect to the plain
        pixel dot product and the real-packed alm dot product."""
        return state_to_flat(self.adjoint_synthesis_state(maps), self.lmax)

    def synthesis_spin2(self, e_flat: torch.Tensor, b_flat: torch.Tensor):
        """(E, B) real-packed alm -> (Q, U) maps."""
        return self.synthesis_spin2_state(
            flat_to_state(e_flat.to(self.dtype), self.lmax),
            flat_to_state(b_flat.to(self.dtype), self.lmax))

    def analysis_spin2(self, q_maps, u_maps):
        """(Q, U) maps -> (E, B) real-packed alm, as ``analysis``."""
        e, b = self.analysis_spin2_state(q_maps, u_maps)
        return state_to_flat(e, self.lmax), state_to_flat(b, self.lmax)

    def adjoint_synthesis_spin2(self, q_maps, u_maps):
        """Exact transpose of ``synthesis_spin2``."""
        e, b = self.adjoint_synthesis_spin2_state(q_maps, u_maps)
        return state_to_flat(e, self.lmax), state_to_flat(b, self.lmax)
