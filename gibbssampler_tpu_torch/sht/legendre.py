"""Associated-Legendre / Wigner-d operator tables (numpy, float64).

A copy of the numpy recurrences of ``gibbssampler_tpu.sht.legendre`` (the
port must not import that package, whose ``sht/__init__`` imports jax).
The tables are built once per (lmax, grid) on the host; the transform
loads them to the device in its compute dtype.

Conventions
-----------
- ``lambda_lm(x)`` is the orthonormal latitude factor:
  Y_lm(theta, phi) = lambda_lm(cos theta) e^{i m phi},
  lambda_lm = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) P_lm (Condon-Shortley).
- Spin-weighted: sLambda_lm = (-1)^s sqrt((2l+1)/(4 pi)) d^l_{m,-s}(theta).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

__all__ = ["legendre_table", "wigner_d_table", "spin2_lambda_tables"]


def legendre_table(lmax: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal lambda_lm(x) for all 0 <= m <= l <= lmax.

    x: (nr,) cos(theta) ring nodes.  Returns (lmax+1, lmax+1, nr) float64,
    [m, l, r]; entries with l < m are 0."""
    x = np.asarray(x, dtype=np.float64)
    nr = x.shape[0]
    L = lmax + 1
    out = np.zeros((L, L, nr))
    sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))  # sin(theta)
    # lambda_00 = sqrt(1/4pi); lambda_{m+1,m+1} = -sqrt((2m+3)/(2m+2)) sx lambda_mm
    lam_mm = np.full(nr, np.sqrt(1.0 / (4.0 * np.pi)))
    for m in range(L):
        out[m, m] = lam_mm
        if m + 1 < L:
            # lambda_{m+1, m} = x sqrt(2m+3) lambda_mm
            out[m, m + 1] = x * np.sqrt(2.0 * m + 3.0) * lam_mm
        for l in range(m + 2, L):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            out[m, l] = a * (x * out[m, l - 1] - b * out[m, l - 2])
        if m + 1 < L:
            lam_mm = -np.sqrt((2.0 * m + 3.0) / (2.0 * m + 2.0)) * sx * lam_mm
    return out


def _d_top_row(j: int, mp, beta: np.ndarray) -> np.ndarray:
    """d^j_{j, mp}(beta) = sqrt((2j)!/((j+mp)!(j-mp)!)) c^{j+mp} (-s)^{j-mp},
    c = cos(beta/2), s = sin(beta/2), in log space (stable for large j)."""
    beta = np.asarray(beta, dtype=np.float64)
    c = np.cos(beta / 2.0)
    s = np.sin(beta / 2.0)
    mp = np.asarray(mp)
    lognorm = 0.5 * (gammaln(2 * j + 1) - gammaln(j + mp + 1)
                     - gammaln(j - mp + 1))
    with np.errstate(divide="ignore"):
        logc = np.where(c > 0, np.log(np.maximum(c, 1e-300)), -np.inf)
        logs = np.where(s > 0, np.log(np.maximum(s, 1e-300)), -np.inf)
    mag = np.exp(lognorm + (j + mp) * logc + (j - mp) * logs)
    # exact pole values (c or s == 0), where the power may be 0
    mag = np.where((c == 0.0) & (j + mp > 0), 0.0, mag)
    mag = np.where((s == 0.0) & (j - mp > 0), 0.0, mag)
    mag = np.where((c == 0.0) & (j + mp == 0), np.exp(lognorm), mag)
    mag = np.where((s == 0.0) & (j - mp == 0), np.exp(lognorm), mag)
    return mag * ((-1.0) ** (j - mp))


def wigner_d_table(lmax: int, s: int, beta: np.ndarray) -> np.ndarray:
    """d^l_{m, s}(beta) for all m = 0..lmax, l = max(m,|s|)..lmax.

    Returns (lmax+1, lmax+1, nr) float64 [m, l, r]; entries with
    l < max(m, |s|) are 0.  Upward three-term recurrence in l, seeded at
    l0 = max(m, |s|) with the closed-form top-row values."""
    beta = np.asarray(beta, dtype=np.float64)
    x = np.cos(beta)
    nr = beta.shape[0]
    L = lmax + 1
    sa = abs(s)
    out = np.zeros((L, L, nr))
    for m in range(L):
        l0 = max(m, sa)
        if l0 > lmax:
            break
        if m >= sa:
            seed = _d_top_row(m, s, beta)  # d^m_{m, s}
        elif s >= 0:
            # d^l_{m,s} = (-1)^{m-s} d^l_{s,m}
            seed = ((-1.0) ** (m - s)) * _d_top_row(s, m, beta)
        else:
            # d^l_{m,-|s|} = d^l_{|s|,-m}
            seed = _d_top_row(sa, -m, beta)
        out[m, l0] = seed
        dl_m1 = np.zeros(nr)  # d^{l0-1} (its coefficient vanishes at l = l0)
        dl = seed
        for l in range(l0, lmax):
            if l == 0:
                # only reachable for m = s = 0: d^1_{00} = x d^0_{00}
                dl_m1, dl = dl, x * dl
                out[m, l + 1] = dl
                continue
            num = ((2 * l + 1.0) * (l * (l + 1.0) * x - m * s) * dl
                   - (l + 1.0) * np.sqrt(max(l * l - m * m, 0.0)
                                         * max(l * l - s * s, 0.0)) * dl_m1)
            den = l * np.sqrt(((l + 1.0) ** 2 - m * m)
                              * ((l + 1.0) ** 2 - s * s))
            dl_m1, dl = dl, num / den
            out[m, l + 1] = dl
    return out


def spin2_lambda_tables(lmax: int, theta: np.ndarray):
    """(2Lambda, -2Lambda) tables for m >= 0: sLambda[m, l, r].

    +2Lambda uses d^l_{m,-2} and -2Lambda uses d^l_{m,+2}."""
    theta = np.asarray(theta, dtype=np.float64)
    L = lmax + 1
    norm = np.sqrt((2.0 * np.arange(L) + 1.0) / (4.0 * np.pi))[None, :, None]
    lam_p2 = wigner_d_table(lmax, -2, theta) * norm
    lam_m2 = wigner_d_table(lmax, +2, theta) * norm
    return lam_p2, lam_m2
