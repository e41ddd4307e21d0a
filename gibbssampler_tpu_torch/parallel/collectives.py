"""Cross-chain statistics over the chain axis, pooled across processes
(PyTorch counterpart of ``gibbssampler_tpu.parallel.collectives``).

The numpy diagnostics (``diagnostics``) run offline on pulled chains;
these reduce on the device where the chains live.  With ``group=None`` (or
a group of one process) each is a plain reduction over the local array,
equal to the JAX function on that array.  With the chains group of a mesh
(``parallel.make_mesh``; ``mesh.get_group("chains")``), each process
passes its own chains and every process gets the statistic of all of
them: sums and counts are added across the group with ``all_reduce``
instead of gathering the chains (the in-band replacement for the
reference's offline SLURM-output pooling, config.py:161-189).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["pooled_moments", "split_rhat_device", "acceptance_mean",
           "ess_device"]


def _pooled(group) -> bool:
    return group is not None and dist.get_world_size(group) > 1


def _global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's processes (a copy; ``t`` itself is
    left as it is)."""
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def pooled_moments(samples: torch.Tensor, chain_axis: int = 0,
                   sample_axis: int = 1, group=None):
    """(mean, var) pooled over chains and samples (var with ddof 0).  Over
    a chains group: the global mean from the global sum and count, then the
    global sum of squared deviations from it."""
    axes = (chain_axis % samples.dim(), sample_axis % samples.dim())
    if not _pooled(group):
        return (samples.mean(dim=axes),
                samples.var(dim=axes, correction=0))
    n = _global_sum(torch.tensor(float(samples.shape[chain_axis]
                                       * samples.shape[sample_axis]),
                                 dtype=samples.dtype, device=samples.device),
                    group)
    mean = _global_sum(samples.sum(dim=axes), group) / n
    dev = samples - mean.reshape(
        [1 if a in axes else s for a, s in enumerate(samples.shape)])
    return mean, _global_sum((dev * dev).sum(dim=axes), group) / n


def split_rhat_device(samples: torch.Tensor, group=None) -> torch.Tensor:
    """Split R-hat per parameter, samples (nchains, niter, ...).  Each chain
    splits into its two halves; W is the mean over all split chains of
    their within-chain variances (ddof 1); B / n the variance (ddof 1, over
    the global count of split chains) of the split chains' means about the
    global mean of those means."""
    niter = samples.shape[1]
    half = niter // 2
    s = torch.cat([samples[:, :half], samples[:, half: 2 * half]], dim=0)
    nn = s.shape[1]
    within = s.var(dim=1, correction=1)                 # (K, ...)
    means = s.mean(dim=1)                               # (K, ...)
    if not _pooled(group):
        w = within.mean(dim=0)
        b = nn * means.var(dim=0, correction=1)
    else:
        k = _global_sum(torch.tensor(float(s.shape[0]), dtype=s.dtype,
                                     device=s.device), group)
        w = _global_sum(within.sum(dim=0), group) / k
        mbar = _global_sum(means.sum(dim=0), group) / k
        b = nn * _global_sum(((means - mbar) ** 2).sum(dim=0), group) \
            / (k - 1.0)
    var_plus = (nn - 1.0) / nn * w + b / nn
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))


def acceptance_mean(accepts: torch.Tensor, chain_axis: int = 0,
                    group=None) -> torch.Tensor:
    """Acceptance averaged over all chains (per block and iteration where
    the array has those axes); boolean accepts count as 0 / 1 in float64."""
    a = accepts if accepts.is_floating_point() else accepts.to(torch.float64)
    if not _pooled(group):
        return a.mean(dim=chain_axis)
    n = _global_sum(torch.tensor(float(a.shape[chain_axis]), dtype=a.dtype,
                                 device=a.device), group)
    return _global_sum(a.sum(dim=chain_axis), group) / n


def ess_device(samples: torch.Tensor, group=None) -> torch.Tensor:
    """Per-parameter ESS of samples (nchains, niter, ...), the estimator of
    ``diagnostics.effective_sample_size`` (Geyer's initial monotone
    positive sequence on the chain-averaged autocorrelation) over all
    chains of the group.  The per-chain autocovariances (by FFT) and chain
    means are summed across the group; only the pooled (niter,)
    autocorrelation of each parameter goes to the host for the sequence.
    Returns a float64 tensor of the parameters' shape on the host."""
    x = samples.to(torch.float64)
    m_loc, n = x.shape[:2]
    xc = x - x.mean(dim=1, keepdim=True)
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    f = torch.fft.rfft(xc, nfft, dim=1)
    acov = torch.fft.irfft(f * f.conj(), nfft, dim=1)[:, :n] / n
    means = x.mean(dim=1)
    if _pooled(group):
        m = _global_sum(torch.tensor(float(m_loc), dtype=x.dtype,
                                     device=x.device), group)
        mean_acov = _global_sum(acov.sum(dim=0), group) / m
        mbar = _global_sum(means.sum(dim=0), group) / m
        ssq = _global_sum(((means - mbar) ** 2).sum(dim=0), group)
        m = float(m)
    else:
        m = float(m_loc)
        mean_acov = acov.mean(dim=0)
        ssq = ((means - means.mean(dim=0)) ** 2).sum(dim=0)
    var_within = mean_acov[0] * n / (n - 1.0)
    var_between = ssq / (m - 1.0) if m > 1 else torch.zeros_like(ssq)
    var_plus = var_within * (n - 1.0) / n + var_between
    rho = (1.0 - (var_within - mean_acov) / var_plus).cpu().numpy()
    var_plus = var_plus.cpu().numpy()
    shape = rho.shape[1:]
    rho = rho.reshape(n, -1)
    vp = var_plus.reshape(-1)
    out = np.empty(vp.size)
    for j in range(vp.size):
        if vp[j] <= 0:
            out[j] = m * n
            continue
        t, rho_sum, prev = 1, 0.0, np.inf
        while t + 1 < n:
            pair = rho[t, j] + rho[t + 1, j]
            if pair < 0:
                break
            pair = min(pair, prev)
            rho_sum += pair
            prev = pair
            t += 2
        out[j] = m * n / max(1.0 + 2.0 * rho_sum, 1.0 / (m * n))
    return torch.as_tensor(out.reshape(shape))
