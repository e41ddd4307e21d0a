"""The forward model d = A B s + n as a bundle of operators (PyTorch
counterpart of ``gibbssampler_tpu.ops.model``, Gauss-Legendre and HEALPix
grids, spin 0, spin 2 and joint TQU).

- state ``s``     : (..., nfields, nstate) grid-packed alm
- pixel data ``d``: (nfields, *pix) maps (T, Q/U or T/Q/U); pix is (nrings,
  nphi) on an iso-latitude grid and (npix,) on HEALPix.  The cut rings'
  and the point set's maps are (nrows, ncols) on either grid.

Leading axes of ``s`` (the chains) are batch axes: every operator maps them
through, and every scalar it returns (log-likelihoods) is one value per
leading index, reduced over the field, slot and pixel axes only.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..diagnostics import trace
from ..harmonics.gridstate import (almxfl_state, ell_mask_state,
                                   expand_cl_state, nstate)
from ..harmonics.spectra import device_constant
from ..sht.grids import SphereGrid, subgrid_rows
from ..sht.healpix import HealpixSHT
from ..sht.points import PointSHT, group_points_by_ring
from ..sht.transform import SHT
from .noise import NoiseModel

__all__ = ["SkyModel", "cut_weights", "healpix_belt_rows",
           "healpix_cut_weights", "with_cut_decomposition"]

# the smallest degree of each field's harmonics, by spin: spin-0 fields
# start at l = 0, spin-2 fields at l = 2
_LMINS = {0: (0,), 2: (2, 2), 3: (0, 2, 2)}

# the JAX package's default bound for the floor + sparse-hole split
# (GS_SPARSE_MAX_FRAC): masks whose azimuthally non-uniform pixels cover at
# most this share of the sky are split
_SPARSE_MAX_FRAC = 0.15


@dataclass(frozen=True)
class SkyModel:
    """Operators for one observed dataset (beam, noise, mask, SHT).

    spin = 0: nfields = 1 (T).  spin = 2: nfields = 2 (E, B alm; Q, U maps).
    spin = 3: joint TQU, nfields = 3: fields (T, E, B) <-> maps (T, Q, U),
    T through the spin-0 transform and (E, B) through the spin-2 one.
    """

    sht: SHT
    noise: NoiseModel
    bl: torch.Tensor                      # (lmax+1,) beam window
    spin: int
    d: Optional[torch.Tensor] = None      # observed maps (nfields, *pix)

    # cut-sky complement decomposition (with_cut_decomposition): on a
    # quadrature grid with uniform unmasked noise A^T diag(tau_bar q) A =
    # (tau_bar/omega) I exactly, so every masked pixel-diagonal operator is
    # an exact harmonic diagonal minus a correction on the masked rings only
    cut_sht: Optional[SHT] = None
    d_cut: Optional[torch.Tensor] = None   # d on cut rows (nf, ncut, nphi)
    w_cut: Optional[torch.Tensor] = None   # q (tau_bar - tau) on cut rows >= 0
    cut_c0: Optional[torch.Tensor] = None  # scalar: d^T N0^-1 d
    cut_c1: Optional[torch.Tensor] = None  # (nfields, nstate): A^T N0^-1 d
    # static flags of w_cut that select the blocked-MH engine: the cut
    # weights are constant along each ring (azimuthally uniform), and equal
    # across the map components
    cut_w_uniform: bool = False
    cut_w_equal_fields: bool = False
    # floor + sparse-hole split of the cut: an azimuthally non-uniform mask
    # (apodized band plus point-source holes) splits into a per-ring floor,
    # held in cut_sht / w_cut above, plus a correction supported on the
    # hole pixels only, applied through a point-set transform
    sp_sht: Optional[PointSHT] = None
    d_sp: Optional[torch.Tensor] = None    # d at the holes (nf, nr_sp, p)
    w_sp: Optional[torch.Tensor] = None    # sparse weights >= 0, 0 on padding

    def __post_init__(self):
        if self.spin not in _LMINS:
            raise NotImplementedError(
                f"spin={self.spin}: the port supports spin 0, 2 and 3")

    @property
    def lmax(self) -> int:
        return self.sht.lmax

    @property
    def nfields(self) -> int:
        return len(_LMINS[self.spin])

    @property
    def nstate(self) -> int:
        return nstate(self.lmax)

    @property
    def map_ndim(self) -> int:
        """Pixel-array rank of the full grid's maps: 2 for (nrings, nphi)
        grids, 1 for HEALPix."""
        return getattr(self.sht, "map_ndim", 2)

    @property
    def has_cut(self) -> bool:
        return self.cut_sht is not None

    @property
    def has_sparse(self) -> bool:
        return self.sp_sht is not None

    def ell_mask(self, dtype=None) -> torch.Tensor:
        """(nstate,) 1 on valid slots with l >= 2."""
        return device_constant(("ell_mask", self.lmax, 2),
                               lambda: ell_mask_state(self.lmax, lmin=2),
                               dtype or self.sht.dtype, self.sht.device)

    def _op_valid_mask(self, dtype) -> torch.Tensor:
        """(nfields, nstate) mask of the slots the synthesis acts on: l >= 0
        for spin-0 fields, l >= 2 for spin-2 fields."""
        lmins = _LMINS[self.spin]
        return device_constant(
            ("op_valid", self.lmax, lmins),
            lambda: np.stack([ell_mask_state(self.lmax, lmin=lm)
                              for lm in lmins]), dtype, self.sht.device)

    @property
    def _t(self) -> bool:
        """Whether field 0 is a spin-0 (T) field."""
        return self.spin != 2

    @property
    def _e(self) -> Optional[int]:
        """Index of the E field of the spin-2 pair, None without one."""
        return {0: None, 2: 0, 3: 1}[self.spin]

    # ---- primitive operators -------------------------------------------

    def beam(self, s: torch.Tensor) -> torch.Tensor:
        """B s (diagonal per-ell, identical for every field)."""
        return almxfl_state(s, self.bl.to(s.dtype), self.lmax)

    def _synthesis_with(self, sht, s: torch.Tensor) -> torch.Tensor:
        """A s through the full grid's, the cut rings' or the point set's
        transform: (..., nfields, nstate) -> (..., nfields, *pix), pix the
        transform's map axes ((nr, nphi), (nrows, p), or (npix,) on
        HEALPix)."""
        nd = getattr(sht, "map_ndim", 2)
        maps = [sht.synthesis_state(s[..., 0, :])] if self._t else []
        e = self._e
        if e is not None:
            maps += sht.synthesis_spin2_state(s[..., e, :], s[..., e + 1, :])
        return torch.stack(maps, dim=-(nd + 1))

    def _adjoint_with(self, sht, f: torch.Tensor) -> torch.Tensor:
        """A^T f: (..., nfields, *pix) -> (..., nfields, nstate)."""
        nd = getattr(sht, "map_ndim", 2)
        field = lambda i: f.select(f.ndim - nd - 1, i)
        out = [sht.adjoint_synthesis_state(field(0))] if self._t else []
        e = self._e
        if e is not None:
            out += sht.adjoint_synthesis_spin2_state(field(e), field(e + 1))
        return torch.stack(out, dim=-2)

    @trace.traced("op.synthesis")
    def synthesis(self, s: torch.Tensor) -> torch.Tensor:
        return self._synthesis_with(self.sht, s)

    @trace.traced("op.adjoint")
    def adjoint_synthesis(self, f: torch.Tensor) -> torch.Tensor:
        return self._adjoint_with(self.sht, f)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        """A B s: the noiseless sky seen by the instrument."""
        return self.synthesis(self.beam(s))

    def project_data(self, f: torch.Tensor) -> torch.Tensor:
        """B^T A^T f = B A^T f (B diagonal)."""
        return self.beam(self.adjoint_synthesis(f))

    # ---- composite operators -------------------------------------------

    def bt_ninv_d(self, d: Optional[torch.Tensor] = None) -> torch.Tensor:
        """B A^T N^-1 d: the data term of the CR mean, once per dataset."""
        d = self.d if d is None else d
        return self.project_data(self.noise.inv_noise * d)

    def q_apply(self, s: torch.Tensor, inv_cvar: torch.Tensor) -> torch.Tensor:
        """Q s = C^-1 s + B A^T N^-1 A B s (full-grid transforms)."""
        mask = self.ell_mask(s.dtype)
        s = s * mask
        out = inv_cvar * s + self.project_data(
            self.noise.inv_noise * self.forward(s))
        return out * mask

    def harmonic_noise_diag(self) -> torch.Tensor:
        """(nfields, nstate) exact diagonal of B A^T N^-1 A B on the full
        sky: g_f b_l^2 with g_f = tau_f / omega."""
        bl2 = expand_cl_state(self.bl.to(self.sht.dtype) ** 2, self.lmax)
        g = self.noise.tau_max / self.noise.omega
        return g[:, None] * bl2[None, :]

    # ---- cut-sky complement operators ------------------------------------

    @trace.traced("op.synthesis_cut")
    def synthesis_cut(self, s: torch.Tensor) -> torch.Tensor:
        """A s restricted to the cut rings (..., nfields, ncut, nphi)."""
        return self._synthesis_with(self.cut_sht, s)

    @trace.traced("op.adjoint_cut")
    def adjoint_synthesis_cut(self, f_cut: torch.Tensor) -> torch.Tensor:
        """A_cut^T f (exact transpose of synthesis_cut)."""
        return self._adjoint_with(self.cut_sht, f_cut)

    @trace.traced("op.synthesis_sp")
    def synthesis_sp(self, s: torch.Tensor) -> torch.Tensor:
        """A s at the sparse hole points (..., nfields, nr_sp, p)."""
        return self._synthesis_with(self.sp_sht, s)

    @trace.traced("op.adjoint_sp")
    def adjoint_synthesis_sp(self, f_sp: torch.Tensor) -> torch.Tensor:
        """A_sp^T f (exact transpose of synthesis_sp)."""
        return self._adjoint_with(self.sp_sht, f_sp)

    @trace.traced("op.synthesis_cut_sp")
    def synthesis_cut_sp(self, s: torch.Tensor):
        """(A_cut s, A_sp s) as one fused pair: the Legendre-stage input
        grids are built once and feed both transforms.  The point values
        are None without the sparse split."""
        if not self.has_sparse:
            return self.synthesis_cut(s), None
        cut, sp = self.cut_sht, self.sp_sht
        mc, ms = [], []
        if self._t:
            g0 = cut._state_grids(s[..., 0, :])
            mc.append(cut.synthesis_from_grids(g0))
            ms.append(sp.synthesis_from_grids(g0))
        e = self._e
        if e is not None:
            ap, am = cut._spin2_stacks(s[..., e, :], s[..., e + 1, :])
            mc += cut._spin2_maps_from_F(*cut._spin2_F_stacks(ap, am))
            ms += sp._spin2_points_from_F(*sp._spin2_F_stacks(ap, am))
        return torch.stack(mc, dim=-3), torch.stack(ms, dim=-3)

    @trace.traced("op.adjoint_cut_sp")
    def adjoint_cut_sp(self, f_cut: torch.Tensor,
                       f_sp: Optional[torch.Tensor]) -> torch.Tensor:
        """A_cut^T f_cut + A_sp^T f_sp, the two contributions summed at
        alm-grid level and recombined once (exact transpose of
        ``synthesis_cut_sp``)."""
        if f_sp is None or not self.has_sparse:
            return self.adjoint_synthesis_cut(f_cut)
        cut, sp = self.cut_sht, self.sp_sht
        out = []
        if self._t:
            a2 = (cut._spin0_agrids(f_cut[..., 0, :, :])
                  + sp._spin0_agrids(f_sp[..., 0, :, :]))
            out.append(cut._grids_to_state(a2))
        e = self._e
        if e is not None:
            g1 = cut._spin2_agrids(*cut._spin2_ring_coefs(
                f_cut[..., e, :, :], f_cut[..., e + 1, :, :]))
            g2 = sp._spin2_agrids(*sp._spin2_ring_coefs(
                f_sp[..., e, :, :], f_sp[..., e + 1, :, :]))
            out += cut._spin2_recombine(*[a + b for a, b in zip(g1, g2)])
        return torch.stack(out, dim=-2)

    def _w_corr(self, sb: torch.Tensor) -> torch.Tensor:
        """A_cut^T (w_cut A_cut u) [+ A_sp^T (w_sp A_sp u)]: the masked
        correction operator, floor rows plus the hole points when split."""
        au_cut, au_sp = self.synthesis_cut_sp(sb)
        return self.adjoint_cut_sp(self.w_cut * au_cut,
                                   None if au_sp is None
                                   else self.w_sp * au_sp)

    def q_apply_cut(self, s: torch.Tensor, inv_cvar: torch.Tensor):
        """Exact masked Q apply via the complement decomposition:
        Q s = (C^-1 + tau_bar/omega b_l^2) s
              - B [A_cut^T (w_cut A_cut B s) + A_sp^T (w_sp A_sp B s)]."""
        mask = self.ell_mask(s.dtype)
        s = s * mask
        corr = self.beam(self._w_corr(self.beam(s)))
        diag = inv_cvar + self.harmonic_noise_diag().to(s.dtype)
        return (diag * s - corr) * mask

    def qn_apply(self, s: torch.Tensor) -> torch.Tensor:
        """B A^T N^-1 A B s (the noise term of Q): the cut-ring complement
        form when the decomposition is attached, full transforms
        otherwise.  The cut form projects onto the operator's valid slots
        first (the transforms annihilate the rest, so the diagonal term
        must too)."""
        if self.has_cut:
            s = s * self._op_valid_mask(s.dtype)
            corr = self.beam(self._w_corr(self.beam(s)))
            return self.harmonic_noise_diag().to(s.dtype) * s - corr
        return self.project_data(self.noise.inv_noise * self.forward(s))

    def cut_data_terms(self):
        """(c0, c1) of the complement likelihood identity
        -1/2 (d - A u)^T N0^-1 (d - A u) = -c0/2 + <c1, u> - tau_bar/(2 om)
        ||u||^2 with N0^-1 = tau_bar q.  One full adjoint, once per dataset."""
        n0 = self.noise.field_bcast(self.noise.tau_max) * self.noise.q_map
        c0 = (n0 * self.d * self.d).sum()
        c1 = self.adjoint_synthesis(n0 * self.d)
        return c0, c1

    @trace.traced("op.loglike_cut")
    def data_loglike_cut(self, u: torch.Tensor,
                         au_cut: Optional[torch.Tensor] = None,
                         au_sp: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-1/2 (d - A u)^T N^-1 (d - A u) via the complement identity, one
        value per leading (chain) index; ``u`` is the beam-applied state.
        Pass ``au_cut = synthesis_cut(u)`` (and, for a split model, ``au_sp
        = synthesis_sp(u)``) when already computed.  A model without the
        sparse split ignores ``au_sp``."""
        u = u * self._op_valid_mask(u.dtype)
        if au_cut is None and au_sp is None:
            au_cut, au_sp = self.synthesis_cut_sp(u)
        if au_cut is None:
            au_cut = self.synthesis_cut(u)
        g = (self.noise.tau_max / self.noise.omega).to(u.dtype)
        quad = (g[:, None] * u * u).sum(dim=(-2, -1))
        cross = (self.cut_c1 * u).sum(dim=(-2, -1))
        r_cut = self.d_cut - au_cut
        cut = (self.w_cut * r_cut * r_cut).sum(dim=(-3, -2, -1))
        out = -0.5 * self.cut_c0 + cross - 0.5 * quad + 0.5 * cut
        if self.has_sparse:
            if au_sp is None:
                au_sp = self.synthesis_sp(u)
            r_sp = self.d_sp - au_sp
            out = out + 0.5 * (self.w_sp * r_sp * r_sp).sum(dim=(-3, -2, -1))
        return out

    @trace.traced("op.loglike_cut_delta")
    def data_loglike_cut_delta(self, u: torch.Tensor, au_cut: torch.Tensor,
                               au_sp: Optional[torch.Tensor], du: torch.Tensor,
                               adu_cut: torch.Tensor,
                               adu_sp: Optional[torch.Tensor],
                               field: Optional[int] = None) -> torch.Tensor:
        """data_loglike_cut(u + du) - data_loglike_cut(u), one value per
        leading (chain) index, given the beam-applied state ``u`` with its
        cut (and hole) maps and the move ``du`` with its own maps ``adu_* =
        synthesis_*(du)``.  ``field``: the one field where ``du`` is not
        zero, when there is one (the state terms then run over it alone).

        The difference is formed term by term before any reduction,

            <du, c1 - g/2 (2 u + du)>
            + <w_cut A du, A du / 2 + A u - d_cut> [+ the same on the holes],

        and each sum is reduced along its last axis in ``du``'s precision and
        in float64 beyond (``sum_last_f64``): the O(1e6)-term totals of the
        two states, which cancel to O(1), are never formed."""
        mask = self._op_valid_mask(du.dtype)
        g = (self.noise.tau_max / self.noise.omega).to(du.dtype)
        c1 = self.cut_c1
        if field is None:
            g, nd = g[:, None], 2
        else:
            u, du, mask = u[..., field, :], du[..., field, :], mask[field]
            c1, g, nd = c1[field], g[field], 1
        du = du * mask
        out = sum_last_f64(du * torch.addcmul(c1, torch.add(du, u, alpha=2.0),
                                              g, value=-0.5), nd)
        out = out + sum_last_f64(self.w_cut * adu_cut * torch.add(
            au_cut, adu_cut, alpha=0.5).sub_(self.d_cut), 3)
        if self.has_sparse:
            out = out + sum_last_f64(self.w_sp * adu_sp * torch.add(
                au_sp, adu_sp, alpha=0.5).sub_(self.d_sp), 3)
        return out.to(du.dtype)


def sum_last_f64(x: torch.Tensor, ndims: int) -> torch.Tensor:
    """The sum over the last ``ndims`` axes, in float64: the last axis is
    reduced in ``x``'s precision, the partial sums in float64 (no float64
    copy of ``x`` is made)."""
    x = x.sum(dim=-1)
    if ndims == 1:
        return x.to(torch.float64)
    return x.sum(dim=tuple(range(-(ndims - 1), 0)), dtype=torch.float64)


def _sparse_auto(n_sp: int, npix: int, sparse_split) -> bool:
    """Whether to take the floor + sparse-hole split: forced by
    ``sparse_split``, or automatic when sparse pixels exist and cover at
    most the JAX package's default share of the sky."""
    if sparse_split is not None:
        return bool(sparse_split) and n_sp > 0
    return 0 < n_sp <= _SPARSE_MAX_FRAC * npix


def cut_weights(tau: np.ndarray, q: np.ndarray, sparse_split=None):
    """The host-side part of :func:`with_cut_decomposition` on an
    iso-latitude grid: from the flat inverse noise ``tau`` (nf, nr, nphi)
    and the relative pixel areas ``q`` (nr, 1), the cut rows, their weights
    w_cut (nf, nrows, nphi) and the sparse weights w_sp (nf, nr, nphi),
    None without the split."""
    tau_bar = tau.reshape(tau.shape[0], -1).max(axis=1)
    w = q * (tau_bar[:, None, None] - tau)
    tol = 1e-12 * tau_bar.max()
    any_rows = np.where(np.any(w > tol, axis=(0, 2)))[0]
    if any_rows.size == 0:
        raise ValueError("model has no masked pixels; cut decomposition "
                         "is pointless on the full sky")
    # azimuthal floor + sparse remainder
    w_floor = w.min(axis=2)                               # (nf, nr)
    w_sp = np.maximum(w - w_floor[:, :, None], 0.0)
    w_sp[w_sp <= tol] = 0.0
    n_sp = int(np.any(w_sp > 0.0, axis=0).sum())
    if not _sparse_auto(n_sp, w_sp[0].size, sparse_split):
        return any_rows, w[:, any_rows, :], None
    rows = np.where(np.any(w_floor > tol, axis=0))[0]
    if rows.size == 0:
        # holes only: one zero-weight floor row keeps the cut transform
        # (and every consumer of it) non-degenerate; w_cut = 0 there
        rows = any_rows[:1]
        w_floor = np.zeros_like(w_floor)
    w_cut = np.broadcast_to(w_floor[:, rows, None],
                            (w.shape[0], rows.size, w.shape[2]))
    return rows, w_cut, w_sp


def healpix_belt_rows(lay, cols):
    """Map flat pixel positions (in the map layout of ``lay``, a
    ``sht.HealpixLayout``) to the equatorial-belt rings holding them.
    Returns (rows, idx): global ring indices and the (nrows, 4 nside)
    layout positions of each ring's pixels.  Raises if a position lies on
    a cap ring: caps have other ring lengths and cannot share the
    uniform-nphi cut transform."""
    cols = np.asarray(cols)
    nb = lay.nb
    if lay.layout == "padded":
        belt_lo = lay.belt_off
        on_belt = (cols >= belt_lo) & (cols < belt_lo + lay.nbelt * nb)
        ring_of = (cols - belt_lo) // nb + lay.ncap
    else:
        start = lay.geo.ring_start
        ring_of = np.searchsorted(start, cols, side="right") - 1
        on_belt = (ring_of >= lay.ncap) & (ring_of < lay.ncap + lay.nbelt)
    if not on_belt.all():
        raise ValueError("HEALPix cut decomposition without the sparse "
                         "split supports masks on equatorial-belt rings "
                         "only (cap rings have varying ring lengths)")
    rows = np.unique(ring_of)
    ring_pix = lay.geo.ring_start[rows][:, None] + np.arange(nb)[None, :]
    return rows, lay.layout_of_ring[ring_pix]


def healpix_cut_weights(lay, tau: np.ndarray, q: np.ndarray,
                        sparse_split=None):
    """The host-side part of the HEALPix cut decomposition, for the map
    layout ``lay`` (a ``sht.HealpixLayout``): from the flat inverse noise
    ``tau`` (nf, npix_layout) and ``q`` (npix_layout,), returns (rows, idx,
    w_cut, sparse): the floor's global belt-ring indices, the (nrows,
    4 nside) layout positions of their pixels, w_cut (nf, nrows, 4 nside)
    and, with the split, sparse = (w_sp (nf, npix_layout), ring, phi,
    layout position) of each hole pixel in RING order (None without it).

    The floor is the per-ring azimuthal minimum over the belt rings only;
    everything else, cap-ring holes included, goes to the sparse set.
    Without the split a masked pixel off the belt raises ValueError."""
    geo = lay.geo
    tau_bar = tau.max(axis=1)
    w = np.maximum(q * (tau_bar[:, None] - tau), 0.0)
    tol = 1e-12 * tau_bar.max()
    cols = np.where(np.any(w > tol, axis=0))[0]
    if cols.size == 0:
        raise ValueError("model has no masked pixels; cut decomposition "
                         "is pointless on the full sky")
    nb, nf = lay.nb, w.shape[0]
    ring_start = geo.ring_start
    pix_of = lay.layout_of_ring
    w_ring = w[:, pix_of]                              # (nf, npix) RING order
    ring_of = np.searchsorted(ring_start, np.arange(geo.npix),
                              side="right") - 1
    # per-ring azimuthal floor over the belt rings (contiguous in RING order)
    belt_lo = lay.ncap
    s0 = int(ring_start[belt_lo])
    w_floor = np.zeros((nf, geo.nrings))
    w_floor[:, belt_lo: belt_lo + lay.nbelt] = w_ring[
        :, s0: s0 + lay.nbelt * nb].reshape(nf, lay.nbelt, nb).min(axis=2)
    w_sp_ring = np.maximum(w_ring - w_floor[:, ring_of], 0.0)
    w_sp_ring[w_sp_ring <= tol] = 0.0
    sp_pix = np.any(w_sp_ring > 0.0, axis=0)
    if not _sparse_auto(int(sp_pix.sum()), geo.npix, sparse_split):
        rows, idx = healpix_belt_rows(lay, cols)
        return rows, idx, w[:, idx], None
    rows = np.where(np.any(w_floor > tol, axis=0))[0]
    if rows.size == 0:
        rows = np.array([belt_lo + lay.nbelt // 2])
        w_floor = np.zeros_like(w_floor)
    idx = pix_of[ring_start[rows][:, None] + np.arange(nb)[None, :]]
    w_cut = np.broadcast_to(w_floor[:, rows, None], (nf, rows.size, nb))
    rp = np.where(sp_pix)[0]                           # RING-order pixels
    r_of = ring_of[rp]
    phi = geo.phi0[r_of] + 2.0 * np.pi * (rp - ring_start[r_of]) \
        / geo.nphi[r_of]
    w_sp = np.zeros_like(w)
    w_sp[:, pix_of] = w_sp_ring
    return rows, idx, w_cut, (w_sp, r_of, phi, pix_of[rp])


def _attach_sparse(model, out, w_sp_flat, d_flat, ring_idx, theta, phi,
                   flat_idx):
    """The point-set transform over the hole pixels, with w_sp and d_sp
    gathered from the (nf, npix_flat) host arrays ``w_sp_flat`` and
    ``d_flat`` at ``flat_idx``."""
    sht = model.sht
    dt, dev = sht.dtype, sht.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                  device=dev)
    theta_rows, phi_pad, valid, gidx = group_points_by_ring(
        ring_idx, theta, phi, flat_idx)
    sp_sht = PointSHT(theta_rows, phi_pad, valid, sht.lmax, dtype=dt,
                      spin0=model._t, spin2=model._e is not None,
                      device=dev, table_dtype=sht.table_dtype,
                      m_block=sht.m_block)
    return dataclasses.replace(
        out, sp_sht=sp_sht, w_sp=t(w_sp_flat[:, gidx] * valid),
        d_sp=None if d_flat is None else t(d_flat[:, gidx] * valid))


def _host(x):
    return None if x is None else x.detach().cpu().numpy()


def _with_cut(model, cut_sht, d_cut, w_cut):
    """``model`` with the cut rows' transform, data and weights, and the
    static flags of w_cut that select the blocked-MH engine."""
    dt, dev = model.sht.dtype, model.sht.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                  device=dev)
    return dataclasses.replace(
        model, cut_sht=cut_sht, d_cut=None if d_cut is None else t(d_cut),
        w_cut=t(w_cut),
        cut_w_uniform=bool(np.allclose(w_cut, w_cut[:, :, :1], rtol=0,
                                       atol=0)),
        cut_w_equal_fields=bool(np.allclose(w_cut, w_cut[:1], rtol=0,
                                            atol=0)))


def _quadrature_cut(model: SkyModel, sparse_split) -> SkyModel:
    rows, w_cut, w_sp = cut_weights(_host(model.noise.tau),
                                    _host(model.noise.q_map), sparse_split)
    sht = model.sht
    d_np = _host(model.d)
    # the full transform's options, on the dense tables (the JAX package's)
    cut_sht = SHT(subgrid_rows(sht.grid, rows), sht.lmax, dtype=sht.dtype,
                  spin2=model._e is not None, device=sht.device,
                  fft_mode=sht.fft_mode, table_dtype=sht.table_dtype,
                  m_block=sht.m_block, ring_split=False)
    out = _with_cut(model, cut_sht,
                    None if d_np is None else d_np[..., rows, :], w_cut)
    if w_sp is not None:
        grid = sht.grid
        nf = w_sp.shape[0]
        rr, cc = np.nonzero(np.any(w_sp > 0.0, axis=0))
        out = _attach_sparse(
            model, out, w_sp.reshape(nf, -1),
            None if d_np is None else d_np.reshape(nf, -1), rr,
            grid.theta[rr], grid.phi0[rr] + 2.0 * np.pi * cc / grid.nphi,
            rr * grid.nphi + cc)
    return out


def _healpix_cut(model: SkyModel, sparse_split) -> SkyModel:
    """The HEALPix cut: the floor over belt rings, which share one nphi =
    4 nside = 2 lmax and are iso-latitude, through a plain ``SHT`` over
    those rows with their phi0, built with ``allow_aliasing=True``; with
    the split the rest, cap-ring holes included, through the point set."""
    sht = model.sht
    lay, geo = sht.lay, sht.geo
    rows, idx, w_cut, sparse = healpix_cut_weights(
        lay, _host(model.noise.tau), _host(model.noise.q_map), sparse_split)
    nb = lay.nb
    tag = hashlib.sha1(rows.tobytes()).hexdigest()[:10]
    cut_grid = SphereGrid(
        name=f"hpbelt{sht.nside}_rows{rows.size}_{tag}",
        theta=geo.theta[rows],
        # weights such that pixel_area is the uniform HEALPix pixel area
        # (only analysis would read them, and the aliased grid has none)
        weights=np.full(rows.size, geo.pixel_area * nb / (2.0 * np.pi)),
        nphi=nb, phi0=geo.phi0[rows])
    cut_sht = SHT(cut_grid, sht.lmax, dtype=sht.dtype,
                  spin2=model._e is not None, device=sht.device,
                  allow_aliasing=True, fft_mode="matmul",
                  table_dtype=sht.table_dtype, m_block=sht.m_block,
                  ring_split=False)
    d_np = _host(model.d)
    out = _with_cut(model, cut_sht, None if d_np is None else d_np[..., idx],
                    w_cut)
    if sparse is not None:
        w_sp, r_of, phi, flat_idx = sparse
        out = _attach_sparse(model, out, w_sp, d_np, r_of, geo.theta[r_of],
                             phi, flat_idx)
    return out


def with_cut_decomposition(model: SkyModel,
                           sparse_split: Optional[bool] = None) -> SkyModel:
    """Attach the cut-sky complement decomposition to a masked model.

    Requires per-field noise that is uniform on unmasked pixels.  The
    masked rings ("cut" rows: any pixel with tau < tau_max) get their own
    SHT; masked operators then cost one transform over those rings instead
    of the full sphere.

    ``sparse_split``: the azimuthal-floor + sparse-hole split for masks
    that are not azimuthally uniform (an apodized band plus point-source
    holes): w = w_floor(theta) + w_sparse(theta, phi), w_floor the per-ring
    azimuthal minimum.  The floor rides the cut rings' SHT (the blocked-MH
    table engine stays eligible) and the remainder, supported on the hole
    pixels only, a point-set transform (``sht.points.PointSHT``).  None
    (the default) splits when sparse pixels exist and cover at most 15% of
    the sky; True / False force the split on / off.

    - On an iso-latitude quadrature grid (Gauss-Legendre) the decomposition
      is exact.
    - On HEALPix the floor runs over belt rings only (``_healpix_cut``) and
      the identity A^T diag(tau_bar q) A = (tau_bar/omega) I holds only to
      the grid's quadrature error (about 1e-2 relative near lmax =
      2 nside), the approximation the HEALPix sampler makes everywhere;
      the pieces supported on the masked pixels stay exact.  Without the
      split a mask off the belt rings raises ValueError."""
    if isinstance(model.sht, HealpixSHT):
        out = _healpix_cut(model, sparse_split)
    elif isinstance(model.sht.grid, SphereGrid):
        out = _quadrature_cut(model, sparse_split)
    else:
        raise ValueError("cut decomposition needs an iso-latitude "
                         "quadrature grid or a HEALPix grid")
    if model.d is not None:
        c0, c1 = out.cut_data_terms()
        out = dataclasses.replace(out, cut_c0=c0, cut_c1=c1)
    return out
