"""Iso-latitude sphere grids (numpy copy of ``gibbssampler_tpu.sht.grids``).

A grid is described by per-ring colatitudes theta, per-ring quadrature
weights w, a uniform nphi, and per-ring first-pixel longitude offsets phi0.
Maps are (..., nrings, nphi) tensors; the solid-angle measure is

    integral f dOmega  ~=  sum_r w_r * (2 pi / nphi) * sum_j f[r, j].

On the Gauss-Legendre grid analysis is the exact inverse of synthesis for
band-limited fields and the adjoint relations hold to machine precision.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

import numpy as np

__all__ = ["SphereGrid", "gauss_legendre_grid", "subgrid_rows"]


@dataclass(frozen=True, eq=False)
class SphereGrid:
    """Iso-latitude grid with uniform ring length."""

    name: str
    theta: np.ndarray       # (nrings,) colatitudes
    weights: np.ndarray     # (nrings,) quadrature weights, sum ~= 2
    nphi: int               # pixels per ring
    phi0: np.ndarray        # (nrings,) longitude of pixel j=0 per ring

    @property
    def nrings(self) -> int:
        return self.theta.shape[0]

    @property
    def npix(self) -> int:
        return self.nrings * self.nphi

    @property
    def pixel_area(self) -> np.ndarray:
        """(nrings,) solid angle represented by one pixel of each ring."""
        return self.weights * (2.0 * np.pi / self.nphi)


def subgrid_rows(grid: SphereGrid, rows) -> SphereGrid:
    """The grid restricted to a static subset of rings (the cut rings of
    the complement decomposition, ``ops.model.with_cut_decomposition``)."""
    idx = np.asarray(rows)
    tag = hashlib.sha1(idx.tobytes()).hexdigest()[:10]
    return SphereGrid(
        name=f"{grid.name}_rows{idx.size}_{tag}",
        theta=grid.theta[idx],
        weights=grid.weights[idx],
        nphi=grid.nphi,
        phi0=grid.phi0[idx],
    )


@functools.lru_cache(maxsize=None)
def gauss_legendre_grid(lmax: int, nrings: int | None = None,
                        nphi: int | None = None) -> SphereGrid:
    """Gauss-Legendre grid exact for products of fields band-limited at
    lmax.  Defaults: nrings = lmax + 1, nphi = 2 lmax + 2."""
    if nrings is None:
        nrings = lmax + 1
    if nphi is None:
        nphi = 2 * lmax + 2
    x, w = np.polynomial.legendre.leggauss(nrings)
    # nodes ascending in x = cos(theta) => theta descending; store north->south
    order = np.argsort(-x)
    return SphereGrid(
        name=f"gl_{lmax}_{nrings}_{nphi}",
        theta=np.arccos(x[order]),
        weights=w[order],
        nphi=int(nphi),
        phi0=np.zeros(nrings),
    )
