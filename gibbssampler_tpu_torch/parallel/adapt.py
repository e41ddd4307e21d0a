"""Proposal scales of the non-centered blocked MH step (numpy only;
copies of the parts of ``gibbssampler_tpu.parallel.adapt`` the schemes'
set-up uses)."""

from __future__ import annotations

import numpy as np

__all__ = ["analytic_proposal_sigma", "block_widths"]


def analytic_proposal_sigma(bl, noise_sigma2, omega, lmax: int, bins,
                            f_sky: float = 1.0):
    """Closed-form noise-dominated proposal std-devs for the non-centered
    blocked MH over binned D_ell.

    Per ell the posterior variance of D_ell in the noise-dominated limit is
    Var(D_l) ~= 2/(2l+1) * (l(l+1)/(2 pi) * omega * N / b_l^2)^2 / f_sky
    (omega = 4 pi / Npix, N = per-pixel noise variance); a bin's proposal
    variance is the mean of its ells' variances divided by the bin length
    (variance of the bin average).  Returns (nbins,) std devs."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    bl = np.asarray(bl, dtype=np.float64)
    scale = (ell * (ell + 1.0)) ** 2 * 2.0 / (4.0 * np.pi ** 2
                                              * (2.0 * ell + 1.0))
    unbinned = (omega * float(noise_sigma2) / bl ** 2) ** 2 * scale \
        / max(float(f_sky), 1e-6)
    bins = np.asarray(bins)
    var = np.array([unbinned[lo:hi].mean() / (hi - lo)
                    for lo, hi in zip(bins[:-1], bins[1:])])
    return np.sqrt(np.maximum(var, 1e-24))


def block_widths(blocks, nbins: int):
    """(nbins,) width of the MH block each bin belongs to (1 for bins not
    covered by any block)."""
    w = np.ones(nbins)
    for (lo, hi) in blocks:
        w[lo:hi] = hi - lo
    return w
