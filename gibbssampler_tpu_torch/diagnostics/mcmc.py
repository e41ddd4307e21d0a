"""MCMC diagnostics (numpy copy of ``gibbssampler_tpu.diagnostics.mcmc``):
ESS, split R-hat, ESJD and per-bin chain summaries over (nchains, niter,
...) blocks."""

from __future__ import annotations

import numpy as np

__all__ = ["effective_sample_size", "split_rhat", "esjd", "summarize_chains"]


def _autocov_fft(x):
    """Per-chain autocovariance via FFT; x: (nchains, n) -> (nchains, n)."""
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n]
    return acov / n


def effective_sample_size(chains: np.ndarray) -> float:
    """ESS of a scalar chain block (nchains, niter): Geyer's initial
    monotone positive sequence on the chain-averaged autocorrelation."""
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


def split_rhat(chains: np.ndarray) -> float:
    """Split-R-hat of a scalar chain block (nchains, niter)."""
    chains = np.asarray(chains, dtype=np.float64)
    m, n = chains.shape
    half = n // 2
    s = np.concatenate([chains[:, :half], chains[:, half: 2 * half]], axis=0)
    nn = s.shape[1]
    w = s.var(axis=1, ddof=1).mean()
    b = nn * s.mean(axis=1).var(ddof=1)
    var_plus = (nn - 1.0) / nn * w + b / nn
    return float(np.sqrt(var_plus / w)) if w > 0 else 1.0


def esjd(chains: np.ndarray) -> float:
    """Expected squared jump distance of a scalar chain block."""
    chains = np.asarray(chains, dtype=np.float64)
    return float(np.mean(np.diff(chains, axis=1) ** 2))


def summarize_chains(dl_chains, burn_frac: float = 0.25) -> dict:
    """Per-bin ESS / R-hat / mean / sd for a (nchains, niter, nbins) block."""
    dl_chains = np.asarray(dl_chains, dtype=np.float64)
    nburn = int(burn_frac * dl_chains.shape[1])
    c = dl_chains[:, nburn:, :]
    nbins = c.shape[-1]
    return {
        "mean": c.mean(axis=(0, 1)),
        "sd": c.std(axis=(0, 1)),
        "ess": np.array([effective_sample_size(c[:, :, b])
                         for b in range(nbins)]),
        "rhat": np.array([split_rhat(c[:, :, b]) for b in range(nbins)]),
        "esjd": np.array([esjd(c[:, :, b]) for b in range(nbins)]),
    }
