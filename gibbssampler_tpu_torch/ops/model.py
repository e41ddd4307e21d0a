"""The forward model d = A B s + n as a bundle of operators (PyTorch
counterpart of ``gibbssampler_tpu.ops.model``, Gauss-Legendre grid,
spin 0 and spin 2).

- state ``s``     : (..., nfields, nstate) grid-packed alm
- pixel data ``d``: (nfields, nrings, nphi) maps (T, or Q/U)

Leading axes of ``s`` (the chains) are batch axes: every operator maps them
through, and every scalar it returns (log-likelihoods) is one value per
leading index, reduced over the field, slot and pixel axes only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..harmonics.gridstate import (almxfl_state, ell_mask_state,
                                   expand_cl_state, nstate)
from ..harmonics.spectra import device_constant
from ..sht.grids import SphereGrid, subgrid_rows
from ..sht.points import PointSHT, group_points_by_ring
from ..sht.transform import SHT
from .noise import NoiseModel

__all__ = ["SkyModel", "cut_weights", "with_cut_decomposition"]

# the JAX package's default bound for the floor + sparse-hole split
# (GS_SPARSE_MAX_FRAC): masks whose azimuthally non-uniform pixels cover at
# most this share of the sky are split
_SPARSE_MAX_FRAC = 0.15


@dataclass(frozen=True)
class SkyModel:
    """Operators for one observed dataset (beam, noise, mask, SHT).

    spin = 0: nfields = 1 (T).  spin = 2: nfields = 2 (E, B alm; Q, U maps).
    """

    sht: SHT
    noise: NoiseModel
    bl: torch.Tensor                      # (lmax+1,) beam window
    spin: int
    d: Optional[torch.Tensor] = None      # observed maps (nfields, nr, nphi)

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
        if self.spin not in (0, 2):
            raise NotImplementedError(
                f"spin={self.spin}: the port supports spin 0 and spin 2")

    @property
    def lmax(self) -> int:
        return self.sht.lmax

    @property
    def nfields(self) -> int:
        return {0: 1, 2: 2}[self.spin]

    @property
    def nstate(self) -> int:
        return nstate(self.lmax)

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
        lmin = 0 if self.spin == 0 else 2
        m = device_constant(("ell_mask", self.lmax, lmin),
                            lambda: ell_mask_state(self.lmax, lmin=lmin),
                            dtype, self.sht.device)
        return m.expand(self.nfields, -1)

    # ---- primitive operators -------------------------------------------

    def beam(self, s: torch.Tensor) -> torch.Tensor:
        """B s (diagonal per-ell, identical for every field)."""
        return almxfl_state(s, self.bl.to(s.dtype), self.lmax)

    def _synthesis_with(self, sht: SHT, s: torch.Tensor) -> torch.Tensor:
        """A s through the full grid's or the cut rings' transform:
        (..., nfields, nstate) -> (..., nfields, nr, nphi)."""
        if self.spin == 0:
            return sht.synthesis_state(s[..., 0, :])[..., None, :, :]
        q, u = sht.synthesis_spin2_state(s[..., 0, :], s[..., 1, :])
        return torch.stack([q, u], dim=-3)

    def _adjoint_with(self, sht: SHT, f: torch.Tensor) -> torch.Tensor:
        """A^T f: (..., nfields, nr, nphi) -> (..., nfields, nstate)."""
        if self.spin == 0:
            return sht.adjoint_synthesis_state(f[..., 0, :, :])[..., None, :]
        e, b = sht.adjoint_synthesis_spin2_state(f[..., 0, :, :],
                                                 f[..., 1, :, :])
        return torch.stack([e, b], dim=-2)

    def synthesis(self, s: torch.Tensor) -> torch.Tensor:
        return self._synthesis_with(self.sht, s)

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

    def synthesis_cut(self, s: torch.Tensor) -> torch.Tensor:
        """A s restricted to the cut rings (..., nfields, ncut, nphi)."""
        return self._synthesis_with(self.cut_sht, s)

    def adjoint_synthesis_cut(self, f_cut: torch.Tensor) -> torch.Tensor:
        """A_cut^T f (exact transpose of synthesis_cut)."""
        return self._adjoint_with(self.cut_sht, f_cut)

    def synthesis_sp(self, s: torch.Tensor) -> torch.Tensor:
        """A s at the sparse hole points (..., nfields, nr_sp, p)."""
        return self._synthesis_with(self.sp_sht, s)

    def adjoint_synthesis_sp(self, f_sp: torch.Tensor) -> torch.Tensor:
        """A_sp^T f (exact transpose of synthesis_sp)."""
        return self._adjoint_with(self.sp_sht, f_sp)

    def synthesis_cut_sp(self, s: torch.Tensor):
        """(A_cut s, A_sp s) as one fused pair: the Legendre-stage input
        grids are built once and feed both transforms.  The point values
        are None without the sparse split."""
        if not self.has_sparse:
            return self.synthesis_cut(s), None
        cut, sp = self.cut_sht, self.sp_sht
        if self.spin == 0:
            g0 = cut._state_grids(s[..., 0, :])
            return (cut.synthesis_from_grids(g0)[..., None, :, :],
                    sp.synthesis_from_grids(g0)[..., None, :, :])
        ap, am = cut._spin2_stacks(s[..., 0, :], s[..., 1, :])
        qc, uc = cut._spin2_maps_from_F(*cut._spin2_F_stacks(ap, am))
        qs, us = sp._spin2_points_from_F(*sp._spin2_F_stacks(ap, am))
        return torch.stack([qc, uc], dim=-3), torch.stack([qs, us], dim=-3)

    def adjoint_cut_sp(self, f_cut: torch.Tensor,
                       f_sp: Optional[torch.Tensor]) -> torch.Tensor:
        """A_cut^T f_cut + A_sp^T f_sp, the two contributions summed at
        alm-grid level and recombined once (exact transpose of
        ``synthesis_cut_sp``)."""
        if f_sp is None or not self.has_sparse:
            return self.adjoint_synthesis_cut(f_cut)
        cut, sp = self.cut_sht, self.sp_sht
        if self.spin == 0:
            a2 = (cut._spin0_agrids(f_cut[..., 0, :, :])
                  + sp._spin0_agrids(f_sp[..., 0, :, :]))
            return cut._grids_to_state(a2)[..., None, :]
        g1 = cut._spin2_agrids(*cut._spin2_ring_coefs(f_cut[..., 0, :, :],
                                                      f_cut[..., 1, :, :]))
        g2 = sp._spin2_agrids(*sp._spin2_ring_coefs(f_sp[..., 0, :, :],
                                                    f_sp[..., 1, :, :]))
        e, b = cut._spin2_recombine(*[a + b for a, b in zip(g1, g2)])
        return torch.stack([e, b], dim=-2)

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

    def cut_data_terms(self):
        """(c0, c1) of the complement likelihood identity
        -1/2 (d - A u)^T N0^-1 (d - A u) = -c0/2 + <c1, u> - tau_bar/(2 om)
        ||u||^2 with N0^-1 = tau_bar q.  One full adjoint, once per dataset."""
        n0 = self.noise.field_bcast(self.noise.tau_max) * self.noise.q_map
        c0 = (n0 * self.d * self.d).sum()
        c1 = self.adjoint_synthesis(n0 * self.d)
        return c0, c1

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


def cut_weights(tau: np.ndarray, q: np.ndarray, sparse_split=None):
    """The host-side part of :func:`with_cut_decomposition`: from the flat
    inverse noise ``tau`` (nf, nr, nphi) and the relative pixel areas ``q``
    (nr, 1), the cut rows, their weights w_cut (nf, nrows, nphi) and the
    sparse weights w_sp (nf, nr, nphi), None without the split."""
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
    split = (bool(sparse_split) and n_sp > 0 if sparse_split is not None
             else 0 < n_sp <= _SPARSE_MAX_FRAC * w_sp[0].size)
    if not split:
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


def with_cut_decomposition(model: SkyModel,
                           sparse_split: Optional[bool] = None) -> SkyModel:
    """Attach the cut-sky complement decomposition to a masked model.

    Requires per-field noise that is uniform on unmasked pixels.  The
    masked rings ("cut" rows: any pixel with tau < tau_max) get their own
    SHT; masked operators then cost one transform over those rings instead
    of the full sphere.  Exact on the Gauss-Legendre quadrature grid.

    ``sparse_split``: the azimuthal-floor + sparse-hole split for masks
    that are not azimuthally uniform (an apodized band plus point-source
    holes): w = w_floor(theta) + w_sparse(theta, phi), w_floor the per-ring
    azimuthal minimum.  The floor rides the cut rings' SHT (the blocked-MH
    table engine stays eligible) and the remainder, supported on the hole
    pixels only, a point-set transform (``sht.points.PointSHT``).  None
    (the default) splits when sparse pixels exist and cover at most 15% of
    the sky; True / False force the split on / off."""
    if not isinstance(model.sht.grid, SphereGrid):
        raise ValueError("cut decomposition needs an iso-latitude "
                         "quadrature grid")
    rows, w_cut, w_sp = cut_weights(model.noise.tau.detach().cpu().numpy(),
                                    model.noise.q_map.detach().cpu().numpy(),
                                    sparse_split)
    sht = model.sht
    dt, dev = sht.dtype, sht.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                  device=dev)
    d_np = None if model.d is None else model.d.detach().cpu().numpy()
    cut_sht = SHT(subgrid_rows(sht.grid, rows), sht.lmax, dtype=dt,
                  spin2=(model.spin == 2), device=dev)
    out = dataclasses.replace(
        model, cut_sht=cut_sht,
        d_cut=None if d_np is None else t(d_np[..., rows, :]),
        w_cut=t(w_cut),
        cut_w_uniform=bool(np.allclose(w_cut, w_cut[:, :, :1], rtol=0,
                                       atol=0)),
        cut_w_equal_fields=bool(np.allclose(w_cut, w_cut[:1], rtol=0,
                                            atol=0)))
    if w_sp is not None:
        grid = sht.grid
        rr, cc = np.nonzero(np.any(w_sp > 0.0, axis=0))
        theta_rows, phi_pad, valid, gidx = group_points_by_ring(
            rr, grid.theta[rr], grid.phi0[rr] + 2.0 * np.pi * cc / grid.nphi,
            rr * grid.nphi + cc)
        nf = w_sp.shape[0]
        sp_sht = PointSHT(theta_rows, phi_pad, valid, sht.lmax, dtype=dt,
                          spin0=(model.spin == 0), spin2=(model.spin == 2),
                          device=dev)
        out = dataclasses.replace(
            out, sp_sht=sp_sht, w_sp=t(w_sp.reshape(nf, -1)[:, gidx] * valid),
            d_sp=None if d_np is None
            else t(d_np.reshape(nf, -1)[:, gidx] * valid))
    if model.d is not None:
        c0, c1 = out.cut_data_terms()
        out = dataclasses.replace(out, cut_c0=c0, cut_c1=c1)
    return out
