"""Pixel-noise model with quadrature-aware weighting (PyTorch counterpart of
``gibbssampler_tpu.ops.noise``).

The noise is parameterized by a flat inverse-noise field
tau(pix) = mask / sigma^2 and

    N^-1 = diag( q * tau ),     q = pixel_area / omega,   omega = 4 pi / npix,

so that on a quadrature grid any pixel-diagonal operator diag(c * q) has the
exactly diagonal harmonic image c / omega * I.  On HEALPix (uniform pixel
areas) q = 1, or the validity mask in the padded layout.

Maps are (nrings, nphi) tensors on iso-latitude grids or flat vectors on
HEALPix; ``pix_ndim`` records which.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["NoiseModel"]


@dataclass(frozen=True)
class NoiseModel:
    """White (masked) pixel noise for one or more Stokes fields.

    tau : (nfields, *pix) flat inverse noise; masked pixels carry 0.
    q_map : broadcastable to pix, relative pixel area (pixel_area / omega).
    omega : mean pixel solid angle 4 pi / npix.
    """

    tau: torch.Tensor
    q_map: torch.Tensor
    omega: float

    @property
    def pix_ndim(self) -> int:
        return self.tau.ndim - 1

    @property
    def _pix_axes(self):
        return tuple(range(-self.pix_ndim, 0))

    @classmethod
    def white(cls, sigma2, grid, nfields: int, mask=None,
              dtype=torch.float32, device="cuda"):
        """Uniform white noise of variance sigma2 (scalar or per field) on an
        iso-latitude grid; optional (nrings, nphi) mask in [0, 1]."""
        omega = 4.0 * np.pi / grid.npix
        q = (grid.pixel_area / omega)[:, None]
        sigma2 = torch.broadcast_to(torch.as_tensor(sigma2, dtype=dtype,
                                                    device=device), (nfields,))
        tau = torch.ones((nfields, grid.nrings, grid.nphi), dtype=dtype,
                         device=device) / sigma2[:, None, None]
        if mask is not None:
            tau = tau * torch.as_tensor(np.array(mask), dtype=dtype,
                                        device=device)
        return cls(tau=tau, q_map=torch.as_tensor(q, dtype=dtype, device=device),
                   omega=float(omega))

    @classmethod
    def white_healpix(cls, sigma2, geo, nfields: int, mask=None,
                      dtype=torch.float32, sht=None, device="cuda"):
        """Uniform white noise on a HEALPix grid: flat maps, q = 1.

        With a padded-layout ``sht`` the noise lives in the padded section
        layout: q_map is the validity mask (0 on padding, so inv_noise = 0
        there and padding never enters a noise-weighted operator), and
        ``mask``, given in RING order, is converted."""
        sigma2 = torch.broadcast_to(torch.as_tensor(sigma2, dtype=dtype,
                                                    device=device), (nfields,))
        m = (None if mask is None
             else torch.as_tensor(np.array(mask), dtype=dtype, device=device))
        if sht is not None and getattr(sht, "layout", "ring") == "padded":
            valid = sht.valid.to(dtype=dtype, device=device)
            tau = valid.expand(nfields, -1) / sigma2[:, None]
            if m is not None:
                tau = tau * sht.from_ring(m.to(sht.device)).to(device)
            return cls(tau=tau, q_map=valid, omega=float(geo.pixel_area))
        tau = torch.ones((nfields, geo.npix), dtype=dtype,
                         device=device) / sigma2[:, None]
        if m is not None:
            tau = tau * m
        return cls(tau=tau, q_map=torch.ones((geo.npix,), dtype=dtype,
                                             device=device),
                   omega=float(geo.pixel_area))

    @property
    def inv_noise(self) -> torch.Tensor:
        """N^-1 per pixel, (nfields, *pix)."""
        return self.tau * self.q_map

    @property
    def tau_max(self) -> torch.Tensor:
        """(nfields,) max flat inverse noise: the aux-variable mu bound."""
        return self.tau.amax(dim=self._pix_axes)

    @property
    def f_sky(self) -> torch.Tensor:
        """(nfields,) effective unmasked sky fraction (area-weighted)."""
        occ = (self.tau > 0).to(self.tau.dtype)
        area = torch.broadcast_to(self.q_map, self.tau.shape[1:])
        return (occ * area).sum(dim=self._pix_axes) / area.sum()

    def harmonic_white_level(self) -> torch.Tensor:
        """(nfields,) g such that A^T N^-1 A = g I when the mask is trivial
        and tau is uniform: g = tau / omega."""
        return self.tau_max / self.omega

    def field_bcast(self, v: torch.Tensor) -> torch.Tensor:
        """Broadcast a (nfields,) vector over the pixel axes."""
        return v.reshape(v.shape + (1,) * self.pix_ndim)
