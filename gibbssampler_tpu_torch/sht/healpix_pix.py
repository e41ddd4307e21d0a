"""HEALPix pixel utilities: ang2pix / pix2ang (RING), ud_grade for masks
(numpy copy of ``gibbssampler_tpu.sht.healpix_pix``).

Host-side numpy implementations of the healpy pixel functions used for mask
handling.  Formulas follow the HEALPix paper (Gorski et al. 2005);
exactness is pinned by ang2pix(pix2ang(p)) == p for every pixel.
"""

from __future__ import annotations

import numpy as np

from .healpix import healpix_geometry

__all__ = ["ang2pix_ring", "pix2ang_ring", "ud_grade", "galactic_band_mask"]


def pix2ang_ring(nside: int, ipix: np.ndarray):
    """RING pixel index -> (theta, phi) of pixel centers."""
    geo = healpix_geometry(nside)
    ipix = np.asarray(ipix, dtype=np.int64)
    ring = np.searchsorted(geo.ring_start, ipix, side="right") - 1
    j = ipix - geo.ring_start[ring]
    theta = geo.theta[ring]
    phi = geo.phi0[ring] + 2.0 * np.pi * j / geo.nphi[ring]
    return theta, phi


def ang2pix_ring(nside: int, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """(theta, phi) -> RING pixel index (vectorized, numpy)."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.mod(np.asarray(phi, dtype=np.float64), 2.0 * np.pi)
    z = np.cos(theta)
    za = np.abs(z)
    tt = phi / (0.5 * np.pi)          # in [0, 4)
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    out = np.empty(theta.shape, dtype=np.int64)

    eq = za <= 2.0 / 3.0
    if np.any(eq):
        t1 = nside * (0.5 + tt[eq])
        t2 = nside * 0.75 * z[eq]
        jp = np.floor(t1 - t2).astype(np.int64)   # ascending edge line
        jm = np.floor(t1 + t2).astype(np.int64)   # descending edge line
        ir = nside + 1 + jp - jm                  # ring counted from z = 2/3
        kshift = 1 - (ir & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = np.mod(ip, 4 * nside)
        out[eq] = ncap + (ir - 1) * 4 * nside + ip

    po = ~eq
    if np.any(po):
        tp = tt[po] - np.floor(tt[po])
        tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1                          # ring from the pole
        ip = np.floor(tt[po] * ir).astype(np.int64)
        ip = np.mod(ip, 4 * ir)
        north = z[po] > 0
        pix_n = 2 * ir * (ir - 1) + ip
        pix_s = npix - 2 * ir * (ir + 1) + ip
        out[po] = np.where(north, pix_n, pix_s)
    return out


def ud_grade(mask: np.ndarray, nside_out: int) -> np.ndarray:
    """Degrade/upgrade a RING-ordered map by pixel-hierarchy averaging
    (hp.ud_grade for masks).  Degrading averages the children whose centers
    fall in each coarse pixel; upgrading replicates parents."""
    mask = np.asarray(mask, dtype=np.float64)
    npix_in = mask.shape[-1]
    nside_in = int(np.sqrt(npix_in / 12))
    assert 12 * nside_in * nside_in == npix_in, npix_in
    if nside_out == nside_in:
        return mask
    if nside_out < nside_in:
        th, ph = pix2ang_ring(nside_in, np.arange(npix_in))
        parent = ang2pix_ring(nside_out, th, ph)
        npix_out = 12 * nside_out * nside_out
        sums = np.zeros(mask.shape[:-1] + (npix_out,))
        counts = np.zeros(npix_out)
        np.add.at(counts, parent, 1.0)
        if mask.ndim == 1:
            np.add.at(sums, parent, mask)
        else:
            for idx in np.ndindex(mask.shape[:-1]):
                np.add.at(sums[idx], parent, mask[idx])
        return sums / counts
    npix_out = 12 * nside_out * nside_out
    th, ph = pix2ang_ring(nside_out, np.arange(npix_out))
    parent = ang2pix_ring(nside_in, th, ph)
    return mask[..., parent]


def galactic_band_mask(nside: int, band_deg: float,
                       apodize_deg: float = 0.0) -> np.ndarray:
    """Analytic +/- band_deg galactic-cut mask in RING order; optional
    cosine apodization."""
    npix = 12 * nside * nside
    th, _ = pix2ang_ring(nside, np.arange(npix))
    lat = np.abs(np.pi / 2.0 - th)
    cut = np.radians(band_deg)
    if apodize_deg <= 0:
        return (lat > cut).astype(np.float64)
    apo = np.radians(apodize_deg)
    x = np.clip((lat - cut) / apo, 0.0, 1.0)
    return 0.5 * (1.0 - np.cos(np.pi * x))
