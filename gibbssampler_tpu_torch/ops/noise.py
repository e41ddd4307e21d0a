"""Pixel-noise model with quadrature-aware weighting (PyTorch counterpart of
``gibbssampler_tpu.ops.noise``, iso-latitude grids).

The noise is parameterized by a flat inverse-noise field
tau(pix) = mask / sigma^2 and

    N^-1 = diag( q * tau ),     q = pixel_area / omega,   omega = 4 pi / npix,

so that on a quadrature grid any pixel-diagonal operator diag(c * q) has the
exactly diagonal harmonic image c / omega * I.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["NoiseModel"]


@dataclass(frozen=True)
class NoiseModel:
    """White (masked) pixel noise for one or more Stokes fields.

    tau : (nfields, nrings, nphi) flat inverse noise; masked pixels carry 0.
    q_map : (nrings, 1) relative pixel area (pixel_area / omega).
    omega : mean pixel solid angle 4 pi / npix.
    """

    tau: torch.Tensor
    q_map: torch.Tensor
    omega: float

    pix_ndim = 2

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

    @property
    def inv_noise(self) -> torch.Tensor:
        """N^-1 per pixel, (nfields, nrings, nphi)."""
        return self.tau * self.q_map

    @property
    def tau_max(self) -> torch.Tensor:
        """(nfields,) max flat inverse noise: the aux-variable mu bound."""
        return self.tau.amax(dim=(-2, -1))

    @property
    def f_sky(self) -> torch.Tensor:
        """(nfields,) effective unmasked sky fraction (area-weighted)."""
        occ = (self.tau > 0).to(self.tau.dtype)
        area = torch.broadcast_to(self.q_map, self.tau.shape[1:])
        return (occ * area).sum(dim=(-2, -1)) / area.sum()

    def field_bcast(self, v: torch.Tensor) -> torch.Tensor:
        """Broadcast a (nfields,) vector over the pixel axes."""
        return v.reshape(v.shape + (1,) * self.pix_ndim)
