"""Point-set spherical-harmonic evaluation: the sparse-hole operator
(PyTorch counterpart of ``gibbssampler_tpu.sht.points``).

Evaluates ``A s`` (and its exact transpose) at a list of sky positions
grouped by iso-latitude ring: each "row" is one colatitude with its own
azimuths, padded to a common width ``p``.  Padded slots are zeroed by the
validity mask on both sides, so synthesis and adjoint stay exact transposes.

Under the floor + sparse-hole split of ``ops.model.with_cut_decomposition``
the azimuthally uniform floor of a mask runs through the cut rings' SHT and
the hole pixels through this operator: the Legendre stage of the grid
transforms (``sht.lcore``, the hand-written kernels) over the point rows,
then a per-row trig product at the exact azimuths.  Conventions match
``sht.transform.SHT`` (same tables, same spin-2 F+/F- assembly); azimuths
are absolute, so there is no per-ring phase rotation.
"""

from __future__ import annotations

import numpy as np
import torch

from .lcore import LegendreCore
from .legendre import legendre_table, spin2_lambda_tables

__all__ = ["PointSHT", "group_points_by_ring"]


def group_points_by_ring(ring_idx, theta, phi, flat_idx, max_width: int = 64):
    """Group a flat point list by ring and pad it to a rectangle.

    ring_idx, theta, phi, flat_idx: (npts,) per-point ring label,
    colatitude, absolute azimuth and index into the caller's flat pixel
    layout.  Returns (theta_rows (nrows,), phi_pad (nrows, p), valid
    (nrows, p), gather_idx (nrows, p) int64: flat_idx per slot, 0 on
    padding).  A ring holding more than ``max_width`` points is split into
    several rows of the same colatitude, so that one dense ring does not
    pad every row to its width."""
    ring_idx = np.asarray(ring_idx)
    order = np.argsort(ring_idx, kind="stable")
    ring_idx = ring_idx[order]
    theta = np.asarray(theta, np.float64)[order]
    phi = np.asarray(phi, np.float64)[order]
    flat_idx = np.asarray(flat_idx, np.int64)[order]
    rows, starts, counts = np.unique(ring_idx, return_index=True,
                                     return_counts=True)
    segs = []                      # (theta, start, count) of each row
    for k in range(rows.size):
        s, c = int(starts[k]), int(counts[k])
        for s0 in range(s, s + c, max_width):
            segs.append((theta[s], s0, min(max_width, s + c - s0)))
    nrows = len(segs)
    p = max(c for (_t, _s, c) in segs)
    phi_pad = np.zeros((nrows, p))
    valid = np.zeros((nrows, p))
    gidx = np.zeros((nrows, p), dtype=np.int64)
    theta_rows = np.empty(nrows)
    for k, (th, s, c) in enumerate(segs):
        theta_rows[k] = th
        phi_pad[k, :c] = phi[s: s + c]
        valid[k, :c] = 1.0
        gidx[k, :c] = flat_idx[s: s + c]
    return theta_rows, phi_pad, valid, gidx


class PointSHT(LegendreCore):
    """Point-evaluation operators for one (point set, lmax, dtype) on one
    device.  "Maps" are (..., nrows, p) value tensors.

    Besides the transforms, the flat-slot view serves the blocked-MH table
    engine: the real points as one unpadded axis of length ``nslots``
    (``slot_row``, ``slot_col``), with per-slot trig tables ``cosF`` /
    ``sinF`` (L, nslots).

    ``table_dtype`` and ``m_block`` are ``SHT``'s options; a point set is
    never ring-split (``ring_split`` False), as in the JAX package."""

    def __init__(self, theta, phi, valid, lmax: int, dtype=torch.float32,
                 spin0: bool = True, spin2: bool = False, device="cuda",
                 table_dtype=None, m_block: int = 128):
        theta = np.asarray(theta, np.float64)        # (nrows,)
        phi = np.asarray(phi, np.float64)            # (nrows, p)
        valid_np = np.asarray(valid, np.float64)
        if phi.ndim != 2 or phi.shape[0] != theta.shape[0]:
            raise ValueError("phi must be (nrows, p) matching theta")
        self._init_core(lmax, theta, dtype, device, table_dtype, m_block,
                        ring_split=False)
        self.theta, self.phi = theta, phi
        self.nrows, self.p = int(phi.shape[0]), int(phi.shape[1])
        L = lmax + 1
        dev = self.device
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        ang = phi[:, None, :] * np.arange(L)[None, :, None]   # (nr, L, p)
        # cos and sin stacked on the m axis: the adjoint's azimuthal stage
        # is one batched product over the point rows
        self.trig = self._trig(np.concatenate([np.cos(ang), np.sin(ang)],
                                              axis=1))
        self.cosT, self.sinT = self.trig[:, :L], self.trig[:, L:]
        self.valid = t(valid_np)
        self.lam0 = (self._table(legendre_table(lmax, np.cos(theta)), "lam0")
                     if spin0 else None)
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if spin2:
            self._build_spin2_tables(*spin2_lambda_tables(lmax, theta))
        vr, vc = np.nonzero(valid_np)
        self.nslots = int(vr.size)
        self.slot_row = torch.as_tensor(vr, dtype=torch.int64, device=dev)
        self.slot_col = torch.as_tensor(vc, dtype=torch.int64, device=dev)
        angF = np.outer(np.arange(L), phi[vr, vc])            # (L, S)
        self.cosF = self._trig(np.cos(angF))
        self.sinF = self._trig(np.sin(angF))

    # -- azimuthal point stage (exact-transpose pair) ----------------------

    def _to_points(self, Cc, Cs):
        """Half-spectrum coefficients (..., nr, L) -> values (..., nr, p):
        v[r, k] = sum_m Cc cos(m phi_rk) + Cs sin(m phi_rk)."""
        rnd = self._round_td
        v = (torch.einsum("...rm,rmp->...rp", rnd(Cc.to(self.dtype)),
                          self.cosT).to(self.dtype)
             + torch.einsum("...rm,rmp->...rp", rnd(Cs.to(self.dtype)),
                            self.sinT).to(self.dtype))
        return v * self.valid

    def _from_points(self, f):
        """Exact transpose of ``_to_points``: values -> (Sc, Ss) trig sums."""
        S = torch.einsum("...rp,rkp->...rk",
                         self._round_td((f * self.valid).to(self.dtype)),
                         self.trig).to(self.dtype)
        L = self.lmax + 1
        return S[..., :L], S[..., L:]

    # -- spin 0 ------------------------------------------------------------

    def synthesis_from_grids(self, g0: torch.Tensor) -> torch.Tensor:
        """Spin-0 point values from a prebuilt ``_state_grids`` array."""
        F = self._lsynth_stack(self.lam0, g0)
        return self._to_points(self.cm * F[..., 0, :, :],
                               -(self.cm * F[..., 1, :, :]))

    def synthesis_state(self, x: torch.Tensor) -> torch.Tensor:
        """A: grid-packed alm state (..., nstate) -> values (..., nr, p)."""
        return self.synthesis_from_grids(self._state_grids(x))

    def _spin0_agrids(self, f: torch.Tensor) -> torch.Tensor:
        """Spin-0 adjoint up to the alm grids (summable across
        transforms)."""
        Sc, Ss = self._from_points(f)
        return self._ladj_stack(self.lam0, torch.stack([Sc, -Ss], dim=-3))

    def adjoint_synthesis_state(self, f: torch.Tensor) -> torch.Tensor:
        """A^T: exact transpose of ``synthesis_state`` (the cm factor is
        absorbed by the grid packing's output scale)."""
        return self._grids_to_state(self._spin0_agrids(f))

    # -- spin 2 ------------------------------------------------------------

    def _require_spin2(self):
        if self.lam_p2 is None:
            raise ValueError("PointSHT built without spin2=True")

    def _spin2_points_from_F(self, Fp_re, Fp_im, Fm_re, Fm_im):
        """(F+, F-) ring Fourier coefficients -> (Q, U) point values (the
        azimuthal assembly of ``SHT._spin2_maps_from_F`` at exact
        azimuths)."""
        Are = Fp_re + Fm_re * self.pos
        Aim = Fp_im + Fm_im * self.pos
        Bre = Fp_re - Fm_re * self.pos
        Bim = Fp_im - Fm_im * self.pos
        # Q = sum Are cos - Aim sin ; U = sum Bim cos + Bre sin
        return self._to_points(Are, -Aim), self._to_points(Bim, Bre)

    def synthesis_spin2_state(self, e_state: torch.Tensor,
                              b_state: torch.Tensor):
        """(E, B) grid-packed states -> (Q, U) point values."""
        self._require_spin2()
        return self._spin2_points_from_F(*self._spin2_F(e_state, b_state))

    def _spin2_ring_coefs(self, q, u):
        """(Q, U) point values -> (Cp_re, Cp_im, Cm_re, Cm_im) trig-sum
        coefficients C+ = sum (Q+iU) e^{-im phi}, C- = sum (Q+iU)
        e^{+im phi} (feeds ``_spin2_agrids``)."""
        qc, qs = self._from_points(q)
        uc, us = self._from_points(u)
        return qc + us, uc - qs, qc - us, uc + qs

    def adjoint_synthesis_spin2_state(self, q: torch.Tensor, u: torch.Tensor):
        """Exact transpose of ``synthesis_spin2_state``."""
        self._require_spin2()
        return self._spin2_alm(*self._spin2_ring_coefs(q, u))

    # -- ell-selected per-bin values (the blocked-MH phi-domain engine) -----

    def values_lsel_spin0_grids(self, g0: torch.Tensor, j_idx, seg=None):
        """Per-bin ell-selected spin-0 values from a prebuilt
        ``_state_grids`` array: (..., nb, nr, p)."""
        F = self._lsel_F(self.lam0, g0, j_idx, seg)
        return self._to_points(self.cm * F[..., 0, :, :],
                               -(self.cm * F[..., 1, :, :]))

    def values_lsel_spin2_grids(self, g: torch.Tensor, sign_p, sign_m,
                                j_idx, seg=None):
        """Per-bin ell-selected spin-2 values from a prebuilt single-field
        grid (``SHT.lsel_grid_spin2_single``): (Q, U), each (..., nb, nr,
        p)."""
        self._require_spin2()
        Fp = self._lsel_F(self.lam_p2, g, j_idx, seg)
        Fm = self._lsel_F(self.lam_m2, g, j_idx, seg)
        return self._spin2_points_from_F(
            sign_p * Fp[..., 0, :, :], sign_p * Fp[..., 1, :, :],
            sign_m * Fm[..., 0, :, :], sign_m * Fm[..., 1, :, :])

    def synthesis_state_lsel(self, x: torch.Tensor, sel) -> torch.Tensor:
        """A applied to each ell subset of x (``sel`` an (nb, L) host
        selector): (..., nb, nr, p) values."""
        F = self._lsynth_stack_binned(self.lam0, self._state_grids(x), sel)
        return self._to_points(self.cm * F[..., 0, :, :],
                               -(self.cm * F[..., 1, :, :]))

    def synthesis_spin2_state_lsel(self, e_state: torch.Tensor,
                                   b_state: torch.Tensor, sel):
        """Spin-2 values of each ell subset of (E, B): (Q, U), each (...,
        nb, nr, p)."""
        self._require_spin2()
        ap, am = self._spin2_stacks(e_state, b_state)
        Fp = self._lsynth_stack_binned(self.lam_p2, ap, sel)
        Fm = self._lsynth_stack_binned(self.lam_m2, am, sel)
        return self._spin2_points_from_F(Fp[..., 0, :, :], Fp[..., 1, :, :],
                                         Fm[..., 0, :, :], Fm[..., 1, :, :])

    # -- flat-slot per-bin values (the blocked-MH table engine) -------------

    def flat_of(self, padded: torch.Tensor) -> torch.Tensor:
        """(..., nrows, p) padded point values -> (..., nslots) flat."""
        return padded[..., self.slot_row, self.slot_col]

    def _slot_tables(self, parts, dtype):
        """Per-slot tables of ``flat_values`` from (lam_s, re_trig, im_trig)
        triples, one per map component: lam_s (L, J, S) slot-expanded
        tables; the grid's real part pairs with ``re_trig``, its imaginary
        part with ``im_trig``.  Returns (J, 2L, ncomp S).  With narrow
        tables each entry is the product of the table-dtype values, rounded
        to the table dtype (the JAX package forms it in the table dtype); a
        wider table's products stay in it (float64), whatever ``dtype``."""
        rnd = self._round_td
        tabs = []
        for lam_s, tre, tim in parts:
            lam_s = lam_s.to(self.hold_dtype)
            tabs.append(torch.stack([rnd(lam_s * tre[:, None, :]),
                                     rnd(lam_s * tim[:, None, :])]))
        tab = torch.stack(tabs, dim=-2)                  # (2, L, J, nc, S)
        J = tab.shape[2]
        return (tab.permute(2, 0, 1, 3, 4).reshape(J, 2 * (self.lmax + 1), -1)
                .to(self.table_dtype if self.wide else dtype).contiguous())

    def flat_tables_spin0(self, j_idx, dtype=None) -> torch.Tensor:
        """Chain-independent slot tables of ``values_flat_spin0_gsel``:
        (J, 2L, S); the (2 - delta_m0) weights are the grid's
        (``flat_values(..., cm=True)``), as in the JAX package, which
        rounds the weighted grid (a float16 value doubled before its
        rounding to a subnormal is not the doubled rounding)."""
        lam_s = self.lsel_table(self.lam0, j_idx)[..., self.slot_row]
        return self._slot_tables([(lam_s, self.cosF, -self.sinF)],
                                 dtype or self.dtype)

    def flat_tables_spin2(self, sign_p, sign_m, j_idx,
                          dtype=None) -> torch.Tensor:
        """Chain-independent slot tables of ``values_flat_spin2_gsel`` for
        a single-field grid selection with signs (sign_p, sign_m) of
        ``SHT.lsel_grid_spin2_single``: (J, 2L, 2S), Q then U."""
        self._require_spin2()
        lamp = self.lsel_table(self.lam_p2, j_idx)          # (L, J, r)
        lamm = self.lsel_table(self.lam_m2, j_idx)
        pos = self.pos[:, None, None]
        lamp, lamm = lamp.to(self.hold_dtype), lamm.to(self.hold_dtype)
        # formed in the table dtype in the JAX package: rounded
        La = self._round_td(sign_p * lamp + sign_m * pos * lamm)
        Lb = self._round_td(sign_p * lamp - sign_m * pos * lamm)
        La, Lb = La[..., self.slot_row], Lb[..., self.slot_row]
        # q = g_re (La cos) - g_im (La sin); u = g_re (Lb sin) + g_im (Lb cos)
        return self._slot_tables([(La, self.cosF, -self.sinF),
                                  (Lb, self.sinF, self.cosF)],
                                 dtype or self.dtype)

    def flat_values(self, gsel: torch.Tensor, tab: torch.Tensor,
                    seg=None, cm: bool = False) -> torch.Tensor:
        """Per-bin ell-selected values on the flat slot axis from a
        pre-gathered grid selection gsel (..., 2, L, J) and its slot
        tables (J, 2L, ncomp S): (..., nb, ncomp S), the bins being the
        J ells, or the columns of the (J, nb) segment matrix ``seg``.
        ``cm``: the grid weighted by (2 - delta_m0) first (the spin-0
        tables of ``flat_tables_spin0``)."""
        if cm:
            gsel = gsel * self.cm[:, None].to(gsel.dtype)
        g = gsel.reshape(gsel.shape[:-3] + (-1, gsel.shape[-1]))
        if self.table_dtype != self.dtype:
            # the grid rounded to the table dtype, as in the JAX package
            g = self._round_td(g.to(self.dtype))
        if self.wide:
            # the real and the imaginary part's float64 sums apart, each
            # rounded to the compute dtype, as the JAX package's two
            # products
            g, L = g.to(tab.dtype), self.lmax + 1
            v = (torch.einsum("...kj,jkx->...jx", g[..., :L, :], tab[:, :L])
                 .to(self.dtype)
                 + torch.einsum("...kj,jkx->...jx", g[..., L:, :],
                                tab[:, L:]).to(self.dtype))
        else:
            v = torch.einsum("...kj,jkx->...jx", g.to(tab.dtype), tab)
        if seg is None:
            return v
        seg = torch.as_tensor(seg, dtype=v.dtype, device=v.device)
        return torch.einsum("...jx,jb->...bx", v, seg)

    def values_flat_spin0_gsel(self, gsel, j_idx, seg=None):
        """Per-bin ell-selected spin-0 values on the flat slot axis:
        (..., nb, S)."""
        return self.flat_values(gsel, self.flat_tables_spin0(j_idx), seg,
                                cm=True)

    def values_flat_spin2_gsel(self, gsel, sign_p, sign_m, j_idx, seg=None):
        """Per-bin ell-selected spin-2 values on the flat slot axis from a
        single-field grid selection: (Q, U), each (..., nb, S)."""
        v = self.flat_values(
            gsel, self.flat_tables_spin2(sign_p, sign_m, j_idx), seg)
        return v[..., : self.nslots], v[..., self.nslots:]
