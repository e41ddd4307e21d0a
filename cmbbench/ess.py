"""The ESS arithmetic of the benchmark, frozen here so that no later change
to the program moves the yardstick.

``effective_sample_size`` is a copy of the port's
``diagnostics.mcmc.effective_sample_size`` (itself the JAX package's):
Geyer's initial monotone positive sequence on the chain-averaged
autocorrelation of a (chains, iterations) block, the pooled ESS of one
bin.  The summaries follow bench.py (bench.py:466-494): the median over
every EE and BB bin, and the BB tail, the median over BB bins whose lower
edge is l >= 300; to them this benchmark adds the 5th percentile over the
same bins as the median.  No burn-in is dropped here: the run burns in
before its window.
"""

from __future__ import annotations

import numpy as np

__all__ = ["effective_sample_size", "bin_ess", "summary", "BB_TAIL_LMIN"]

BB_TAIL_LMIN = 300


def _autocov_fft(x):
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n]
    return acov / n


def effective_sample_size(chains: np.ndarray) -> float:
    """Pooled ESS of a scalar chain block (nchains, niter)."""
    chains = np.asarray(chains, dtype=np.float64)
    m, n = chains.shape
    acov = _autocov_fft(chains)
    mean_acov = acov.mean(axis=0)
    var_within = mean_acov[0] * n / (n - 1.0)
    var_between = chains.mean(axis=1).var(ddof=1) if m > 1 else 0.0
    var_plus = var_within * (n - 1.0) / n + var_between
    if var_plus <= 0:
        return float(m * n)
    rho = 1.0 - (var_within - mean_acov) / var_plus
    t = 1
    rho_sum = 0.0
    prev_pair = np.inf
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        rho_sum += pair
        prev_pair = pair
        t += 2
    tau = max(1.0 + 2.0 * rho_sum, 1.0 / (m * n))
    return float(m * n / tau)


def bin_ess(dl_chains: np.ndarray) -> np.ndarray:
    """Per-bin pooled ESS of a (nchains, niter, nbins) block."""
    return np.array([effective_sample_size(dl_chains[:, :, b])
                     for b in range(dl_chains.shape[-1])])


def summary(ess_fields, bb_edges) -> dict:
    """{"median", "p05", "bb_tail"} of per-field per-bin ESS (EE, BB),
    ``bb_edges`` the BB bins' edges.  The tail of a run without BB bins
    at l >= 300 is 0.0."""
    allb = np.concatenate(ess_fields)
    tail = np.asarray(ess_fields[-1])[np.asarray(bb_edges)[:-1]
                                      >= BB_TAIL_LMIN]
    return {"median": float(np.median(allb)),
            "p05": float(np.percentile(allb, 5)),
            "bb_tail": float(np.median(tail)) if tail.size else 0.0}
