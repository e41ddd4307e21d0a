"""Legendre-stage core of the transforms (PyTorch counterpart of
``gibbssampler_tpu.sht.lcore``).

The latitude stage is a per-m contraction between the triangular
(m, l, ring) operator tables and (..., m, l) alm grids.  Each table is one
dense (L, L, nr) tensor on the device; the kernels of
``sht.legendre_kernels`` skip its zero triangle (l < m) themselves, which
replaces the JAX package's m-block wedge slices (``m_block`` is kept, and
passed on to derived transforms, but changes no result and no launch).
The ``_lsynth_stack`` / ``_ladj_stack`` pair below is the only route to the
Legendre stage: it folds every leading axis (chains, fields, re/im) into the
kernels' batch axis C.  ``lsel_table`` is the only read of a table by ell
(``_lsel_F`` and the blocked-MH engines' tables go through it); an
m-sharded copy (``parallel.shard_sht``) overrides these three.

The north/south ring-parity split (``ring_split``, on a grid whose rings
mirror each other about the equator, ``grid_symmetric``): lambda_lm(pi -
theta) = (-1)^(l+m) lambda_lm(theta), so each table is stored over the
ceil(nr / 2) north rings only (the equator row last when nr is odd), and
the pair above runs the kernels' parity mode
(``legendre_synth_par`` / ``legendre_adj_par``), which mirrors the sums
over even and odd l - m into the south rings itself: half the table bytes
and, at spin 0, half the products.  Spin 2 uses the half-sum and
half-difference tables W = (lam+2 + lam-2)/2 and X = (lam+2 - lam-2)/2,
which have definite reflection parity (X the opposite one: ``flip``),
contracted against the four-component [Ere, Eim, Bre, Bim] stack.  The
JAX package's ``par_sign`` (the (-1)^m of the mirrored rows) lives in the
kernels: in terms of l - m the sign does not depend on m.  The split has
no ell-selected, binned or shared-stack syntheses; those raise, as in the
JAX package.

Tables in another dtype than the compute dtype (``table_dtype``, the
pairs of ``TABLE_PAIRS``): every table is stored in the table dtype and
the kernels run their mode for the pair (``sht.legendre_kernels``), the JAX
package's ``einsum(table, g.astype(table_dtype),
preferred_element_type=dtype)``.  A narrower table (bfloat16 or float16
with float32 compute; bfloat16, float16 or float32 with float64 compute)
rounds the batch to the table dtype and sums the exact products in the
compute dtype; float64 -> float16 is one rounding (``legendre_kernels.
cast_to``; torch's own conversion rounds twice, through float32).  A wider
table (float64 with float32 compute: ``wide``) widens the batch exactly,
sums its float64 products in float64 and rounds each output once to the
compute dtype, here and in every azimuthal product against the float64
trig matrices (``_round_td`` widens, ``_trig`` keeps float64; each product
is then rounded by ``.to(dtype)``).  Under the split the JAX package keeps
the equator row of each half table in the compute dtype; so does the port:
the half table holds a zero equator row, which the parity kernels contract
to nothing, and ``eq_rows`` holds the compute-dtype row, contracted in the
compute dtype by ``_synth_par`` (against the rounded grid) and
``_adj_par`` (against the unrounded ring coefficients), as in the JAX
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..diagnostics import trace
from ..harmonics.gridstate import flat_to_state, state_masks, state_to_flat
from .legendre_kernels import (cast_to, legendre_adj_par, legendre_adj_tri,
                               legendre_synth_par, legendre_synth_tri)

__all__ = ["FlatAlmMethods", "LegendreCore", "grid_symmetric"]

_NO_LSEL = "ell-selected synthesis requires ring_split=False tables"
# the (table, compute) dtype pairs of tables in another dtype than the
# computation: narrower ones, then the one wider table
TABLE_PAIRS = ((torch.bfloat16, torch.float32),
               (torch.float16, torch.float32),
               (torch.bfloat16, torch.float64),
               (torch.float16, torch.float64),
               (torch.float32, torch.float64),
               (torch.float64, torch.float32))


def grid_symmetric(theta) -> bool:
    """True when ring r mirrors ring nrings-1-r about the equator; only
    theta symmetry matters: weights and phi0 enter per-ring stages that
    commute with the split."""
    th = np.asarray(theta)
    if th.shape[0] < 2:
        return False
    return bool(np.allclose(th + th[::-1], np.pi, rtol=0, atol=1e-12))


def resolve_table_dtype(table_dtype, dtype):
    """The operator tables' dtype: None (the compute dtype), the compute
    dtype itself or another of ``TABLE_PAIRS``; each as a torch dtype, its
    name, or a numpy (ml_dtypes) dtype or type.  Another pair raises
    NotImplementedError."""
    if table_dtype is None:
        return dtype
    td = table_dtype
    if not isinstance(td, (torch.dtype, str)):
        # a numpy dtype (.name) or scalar type (.__name__)
        td = getattr(td, "name", None) or getattr(td, "__name__", None)
    if isinstance(td, str):
        td = getattr(torch, td, None)
    if td == dtype or (td, dtype) in TABLE_PAIRS:
        return td
    raise NotImplementedError(
        f"table_dtype={table_dtype} with compute dtype {dtype}: the "
        "port takes tables in the compute dtype, bfloat16 or float16 "
        "tables with float32 compute, bfloat16, float16 or float32 tables "
        "with float64 compute, or float64 tables with float32 compute")


def legendre_span(kind: str):
    """Span ``sht.legendre`` around a Legendre-stage call, its args the
    call's kind, rings, batch columns C and table dtype."""
    return trace.traced("sht.legendre", lambda self, lam, g, *a, **k: (
        f"kind={kind} nr={2 * self.nrh + self.has_mid} "
        f"C={math.prod(g.shape[:-2])} "
        f"table={str(lam.dtype).replace('torch.', '')}"))


class LegendreCore:
    """Mixin holding the Legendre contraction and the state packing."""

    def _init_core(self, lmax: int, theta, dtype, device, table_dtype=None,
                   m_block: int = 128, ring_split: bool = False):
        self.lmax = lmax
        self.dtype = dtype
        self.table_dtype = resolve_table_dtype(table_dtype, dtype)
        # a table wider than the compute dtype (float64 under float32)
        self.wide = self.table_dtype.itemsize > dtype.itemsize
        # the dtype that holds table-dtype values exactly: the wider one
        self.hold_dtype = self.table_dtype if self.wide else dtype
        # split tables in another dtype: {table name: its compute-dtype
        # equator row}
        self.eq_rows = {}
        self.m_block = int(m_block)
        nr = np.asarray(theta).shape[0]
        # a grid that is not equator-symmetric takes the dense tables, as
        # in the JAX package
        self.ring_split = bool(ring_split) and grid_symmetric(theta)
        self.nrh = nr // 2
        self.has_mid = bool(nr % 2)
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

    def _table_theta(self, theta) -> np.ndarray:
        """The rings the tables are built at: all, or under the split the
        ceil(nr / 2) north ones."""
        theta = np.asarray(theta, dtype=np.float64)
        return theta[: self.nrh + self.has_mid] if self.ring_split else theta

    def _host(self, a, td) -> torch.Tensor:
        """A float64 host array in dtype ``td`` on the device, rounded once
        (numpy's float16 conversion: torch's goes through float32)."""
        a = np.asarray(a)
        if td == torch.float16:
            return torch.from_numpy(a.astype(np.float16)).to(self.device)
        return torch.as_tensor(a, dtype=td, device=self.device)

    def _table(self, tab, name: str) -> torch.Tensor:
        """fp64 numpy (L, L, nt) table at ``_table_theta``'s rings ->
        contiguous device tensor in the table dtype, to be stored as
        attribute ``name``.  A split table in another dtype than the
        compute dtype has its equator row in ``eq_rows[name]`` in the
        compute dtype, and zero in the table."""
        t = self._host(tab, self.table_dtype).contiguous()
        if self.ring_split and self.has_mid and self.table_dtype != self.dtype:
            self.eq_rows[name] = torch.as_tensor(
                np.ascontiguousarray(tab[:, :, -1]), dtype=self.dtype,
                device=self.device)
            t[:, :, -1] = 0
        return t

    def _build_spin2_tables(self, lp, lm_):
        """Store (lam_p2, lam_m2) dense or (lam_w, lam_x) under the split,
        from the (+2, -2) tables at ``_table_theta``'s rings (fp64 numpy;
        both are overwritten)."""
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if self.ring_split:
            w = lp + lm_
            w *= 0.5
            lp -= lm_
            lp *= 0.5
            self.lam_w = self._table(w, "lam_w")
            self.lam_x = self._table(lp, "lam_x")
        else:
            self.lam_p2 = self._table(lp, "lam_p2")
            self.lam_m2 = self._table(lm_, "lam_m2")

    def _round_td(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the JAX package's ``t.astype(table_dtype)`` before a
        product that it asks for in the compute dtype: rounded to a
        narrower table dtype and held in the compute dtype; widened to a
        wider one (the product, in float64, is then rounded by
        ``.to(dtype)``); the identity for tables in the compute dtype."""
        if self.table_dtype == self.dtype:
            return t
        if self.wide:
            return t.to(self.table_dtype)
        return cast_to(t, self.table_dtype).to(self.dtype)

    def _trig(self, a) -> torch.Tensor:
        """A host (float64) trig matrix as the azimuthal stages hold it:
        rounded to the table dtype, as the JAX package stores it, and kept
        in the compute dtype, so that a plain product of it with a rounded
        operand forms the JAX package's exact products of table-dtype
        values; a wider table dtype's matrix is kept in it (float64)."""
        return self._host(np.ascontiguousarray(a),
                          self.table_dtype).to(self.hold_dtype)

    def _equator_row(self, lam: torch.Tensor):
        """The compute-dtype equator row (M, L) of the split table ``lam``
        in another dtype (one of this transform's own), or None."""
        for name, row in self.eq_rows.items():
            if getattr(self, name) is lam:
                return row
        return None

    def _synth_par(self, lam, x, flip, ms=None):
        """The parity synthesis of the (M, C, L) batch view ``x`` over all
        the grid's rings, with the equator row of a split table in another
        dtype contracted in the compute dtype against the grid rounded to
        the table dtype (held in the compute dtype: a wider table's
        widening is exact)."""
        out = legendre_synth_par(lam, x, 2 * self.nrh + self.has_mid, flip,
                                 ms)
        mid = self._equator_row(lam)
        if mid is not None:
            out[:, self.nrh] = torch.einsum(
                "ml,mcl->mc", mid, self._round_td(x).to(self.dtype))
        return out

    def _adj_par(self, lam, gk, flip, ms=None):
        """The parity adjoint of the (M, nr, C) view ``gk`` -> (M, C, L),
        with the equator row of a split table in another dtype added in the
        compute dtype."""
        out = legendre_adj_par(lam, gk, flip, ms)
        mid = self._equator_row(lam)
        if mid is not None:
            out += mid[:, None, :] * gk[:, self.nrh, :, None]
        return out

    def lsel_table(self, lam: torch.Tensor, j_idx) -> torch.Tensor:
        """The (L, J, nr) slice of a dense (L, L, nr) table at the selected
        ells ``j_idx`` (a host array or a tensor; zero where m > ell, as
        the table itself is)."""
        if self.ring_split:
            raise NotImplementedError(_NO_LSEL)
        if not isinstance(j_idx, torch.Tensor):
            j_idx = torch.as_tensor(np.asarray(j_idx, dtype=np.int64))
        return lam[:, j_idx.to(lam.device), :]

    # -- state <-> grid packing (reshape + diagonal scale) -----------------

    @trace.traced("sht.pack")
    def _state_grids(self, x: torch.Tensor) -> torch.Tensor:
        """Grid-packed state (..., nstate) -> scaled (..., 2, L, L) grids."""
        L = self.lmax + 1
        g = x.reshape(x.shape[:-1] + (2, L, L)).to(self.dtype)
        return g * self.pack_in

    @trace.traced("sht.pack")
    def _grids_to_state(self, g2: torch.Tensor) -> torch.Tensor:
        """Stacked (..., 2, L, L) true Re/Im grids -> grid-packed state."""
        L = self.lmax + 1
        return (g2 * self.pack_out).reshape(g2.shape[:-3] + (2 * L * L,))

    # -- contraction cores -------------------------------------------------

    @legendre_span("synth")
    def _lsynth_stack(self, lam: torch.Tensor, g2: torch.Tensor,
                      flip: bool = False) -> torch.Tensor:
        """(..., c, L, L) [.., m, l] grids -> F (..., c, nr, L) [.., r, m].
        ``flip``: the table's opposite reflection parity (the spin-2 X
        table; meaningful under the split only)."""
        L = self.lmax + 1
        batch = g2.shape[:-2]
        C = math.prod(batch)
        x = g2.reshape(C, L, L).transpose(0, 1)     # (m, C, l) view, no copy
        if self.ring_split:
            out = self._synth_par(lam, x, flip)
        else:
            out = legendre_synth_tri(lam, x)        # (m, nr, C)
        nr = out.shape[1]
        return out.permute(2, 1, 0).reshape(batch + (nr, L))

    @legendre_span("lsel")
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
        over J.  With tables in another dtype, as in the JAX package, the
        grid is rounded to the table dtype, the product is formed in the
        table dtype (so rounded), and the segment sums, of the segment
        matrix in the table dtype, are taken in the wider of the two dtypes
        (a matrix product of narrow tensors would round its result) and
        rounded to the compute dtype."""
        if self.ring_split:
            raise NotImplementedError(_NO_LSEL)
        if not isinstance(j_idx, torch.Tensor):
            j_idx = torch.as_tensor(np.asarray(j_idx, dtype=np.int64))
        idx = j_idx.to(g2.device)
        # (J, r, m)
        lamj = self.lsel_table(lam, idx).permute(1, 2, 0).contiguous()
        gj = cast_to(g2, lam.dtype)[..., idx].movedim(-1, -3)  # (..., J, c, m)
        # (..., J, c, 1, m) * (J, 1, r, m) -> (..., J, c, r, m), in the
        # wider dtype
        sd = self.hold_dtype
        prod = (gj.unsqueeze(-2) * lamj.unsqueeze(-3)).to(sd)
        if seg is None:
            return prod.to(self.dtype)
        if not isinstance(seg, torch.Tensor):
            seg = torch.as_tensor(np.asarray(seg))
        seg = seg.to(dtype=lam.dtype, device=prod.device).to(sd)
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
        if self.ring_split:
            raise NotImplementedError(
                "binned synthesis requires ring_split=False tables")
        sel = np.asarray(sel.detach().cpu() if isinstance(sel, torch.Tensor)
                         else sel, dtype=np.float64)
        bs, ls = np.nonzero(sel)                       # bin-major order
        seg = np.zeros((ls.size, sel.shape[0]))
        seg[np.arange(ls.size), bs] = sel[bs, ls]
        return self._lsel_F(lam, g2, ls, seg)

    @legendre_span("adj")
    def _ladj_stack(self, lam: torch.Tensor, g: torch.Tensor,
                    flip: bool = False) -> torch.Tensor:
        """(..., c, nr, L) [.., r, m] ring grids -> (..., c, L, L) alm grids,
        contiguous; ``flip`` as in ``_lsynth_stack``."""
        L = self.lmax + 1
        batch = g.shape[:-2]
        nr = g.shape[-2]
        C = math.prod(batch)
        # one copy into (m, C, r) order, passed as the (m, r, C) view
        gk = g.reshape(C, nr, L).permute(2, 0, 1).contiguous().transpose(1, 2)
        # (m, C, l) view of a (C, m, l) tensor
        out = (self._adj_par(lam, gk, flip) if self.ring_split
               else legendre_adj_tri(lam, gk))
        return out.transpose(0, 1).reshape(batch + (L, L))

    def _ladj2(self, lam, Gre, Gim):
        """(Gre, Gim) (..., nr, L) -> (are, aim) (..., L, L) grids."""
        a = self._ladj_stack(lam, torch.stack([Gre, Gim], dim=-3))
        return a[..., 0, :, :], a[..., 1, :, :]

    # -- spin-2 Legendre stages --------------------------------------------

    @trace.traced("sht.pack")
    def _spin2_stacks(self, e_state, b_state):
        """(ap, am) Legendre-stage input stacks of a+ = -(E + iB),
        a- = -(E - iB) (dense tables only)."""
        if self.ring_split:
            raise NotImplementedError("stack sharing needs dense tables")
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
        if not self.ring_split:
            return self._spin2_F_stacks(*self._spin2_stacks(e_state,
                                                            b_state))
        # lam_p2 = W + X, lam_m2 = W - X: two definite-parity half-ring
        # contractions of the [Ere, Eim, Bre, Bim] stack, recombined
        eg = self._state_grids(e_state)
        bg = self._state_grids(b_state)
        stack = torch.cat([eg, bg], dim=-3)
        we, wei, wbr, wbi = self._lsynth_stack(self.lam_w, stack).unbind(-3)
        xe, xei, xbr, xbi = self._lsynth_stack(self.lam_x, stack,
                                               flip=True).unbind(-3)
        return (-(we + xe) + (wbi + xbi), -(wei + xei) - (wbr + xbr),
                -(we - xe) - (wbi - xbi), -(wei - xei) + (wbr - xbr))

    def _spin2_agrids(self, Cp_re, Cp_im, Cm_re, Cm_im):
        """Ring coefficients -> (ap_re, ap_im, am_re, am_im) alm grids (the
        Legendre adjoint of ``_spin2_F``; C- enters conjugated)."""
        ap_re, ap_im = self._ladj2(self.lam_p2, Cp_re, Cp_im)
        am_re, am_im = self._ladj2(self.lam_m2, Cm_re, -Cm_im)
        return ap_re, ap_im, am_re, am_im

    @trace.traced("sht.pack")
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
        if not self.ring_split:
            return self._spin2_recombine(
                *self._spin2_agrids(Cp_re, Cp_im, Cm_re, Cm_im))
        # the transpose of the split ``_spin2_F``
        stack = torch.stack([Cp_re + Cm_re, Cp_im - Cm_im, Cp_re - Cm_re,
                             Cp_im + Cm_im], dim=-3)
        AW = self._ladj_stack(self.lam_w, stack)
        AX = self._ladj_stack(self.lam_x, stack, flip=True)
        e_re = -0.5 * (AW[..., 0, :, :] + AX[..., 2, :, :])
        e_im = -0.5 * (AW[..., 1, :, :] + AX[..., 3, :, :])
        b_re = -0.5 * (AW[..., 3, :, :] + AX[..., 1, :, :])
        b_im = 0.5 * (AW[..., 2, :, :] + AX[..., 0, :, :])
        return (self._grids_to_state(torch.stack([e_re, e_im], dim=-3)),
                self._grids_to_state(torch.stack([b_re, b_im], dim=-3)))


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
