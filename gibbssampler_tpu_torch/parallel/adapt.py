"""Proposal scales of the non-centered blocked MH step (copies of
``gibbssampler_tpu.parallel.adapt``): the analytic seed, the scales pooled
from chains, and the in-band warm-up that rescales them per block toward
the random-walk acceptance window."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["analytic_proposal_sigma", "pooled_proposal_sigmas",
           "block_widths", "proposal_sigmas_from_results", "rescale_sigmas",
           "adapt_segments"]


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


def pooled_proposal_sigmas(dl_chains, scale: float = 2.38,
                           floor: float = 1e-12, block_width=None):
    """Proposal sd per bin from the chains' pooled variance: 2.38 sd(D_bin)
    / sqrt(d), d the width (in bins) of the MH block the bin belongs to
    (``block_width``, default 1)."""
    dl_chains = np.asarray(dl_chains, dtype=np.float64)
    sd = dl_chains.reshape(-1, dl_chains.shape[-1]).std(axis=0)
    if block_width is not None:
        sd = sd / np.sqrt(np.maximum(np.asarray(block_width,
                                                dtype=np.float64), 1.0))
    return np.maximum(scale * sd, floor)


def block_widths(blocks, nbins: int):
    """(nbins,) width of the MH block each bin belongs to (1 for bins not
    covered by any block)."""
    w = np.ones(nbins)
    for (lo, hi) in blocks:
        w[lo:hi] = hi - lo
    return w


def proposal_sigmas_from_results(npz_path, nfields: int | None = None,
                                 scale: float = 2.38, burn_frac: float = 0.2,
                                 blocks_list=None):
    """Proposal std-devs pooled from a previous run's saved chains: the npz
    keys ``dl_chain_<f>``, each (nchains, n_iter, nbins), burn-in dropped.
    ``blocks_list`` (per-field [(lo, hi)] MH blocks): when given, each
    bin's sd is scaled by 2.38 / sqrt(d_block)."""
    z = np.load(str(npz_path))
    fields = [k for k in z.files if k.startswith("dl_chain_")]
    fields.sort(key=lambda k: int(k.split("_")[-1]))
    if nfields is not None:
        fields = fields[:nfields]
    out = []
    for fi, k in enumerate(fields):
        c = np.asarray(z[k], dtype=np.float64)     # (nchains, n_iter, nbins)
        c = c[:, int(burn_frac * c.shape[1]):]
        bw = (block_widths(blocks_list[fi], c.shape[-1])
              if blocks_list is not None else None)
        out.append(pooled_proposal_sigmas(c, scale=scale, block_width=bw))
    return out


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def rescale_sigmas(sig, out, blocks_list, target_accept=(0.2, 0.5)):
    """One step of the warm-up rule from a segment's ``run`` output:
    per block, below the window multiply the scale by max(acc / lo, 0.3),
    above it by min(1 + 2 (acc - hi), 3); one global factor per field when
    ``blocks_list`` is None.  Returns (new sigmas, per-field per-block
    acceptances, None where the run has no MH accept history)."""
    lo, hi = target_accept

    def factor(acc):
        if acc < lo:
            return max(acc / lo, 0.3)
        if acc > hi:
            return min(1.0 + (acc - hi) * 2.0, 3.0)
        return 1.0

    new_sig, accs = [], []
    for f in range(len(sig)):
        fac = np.ones(len(sig[f]))
        acc_b = None
        if "mh_accept" in out and blocks_list is not None:
            # (nchains, n_iter, nblocks_f) -> per-block acceptance (none
            # for a field without blocks)
            nb = len(blocks_list[f])
            acc_b = (_host(out["mh_accept"][f]).reshape(-1, nb).mean(axis=0)
                     if nb else np.zeros(0))
            for (blo, bhi), a in zip(blocks_list[f], acc_b):
                fac[blo:bhi] = factor(float(a))
        elif "mh_accept" in out:
            acc_b = np.array([_host(out["mh_accept"][f]).mean()])
            fac[:] = factor(float(acc_b[0]))
        new_sig.append(np.maximum(sig[f] * fac, 1e-12))
        accs.append(acc_b)
    return new_sig, accs


def adapt_segments(make_scheme, gen, dl_init_tuple, sigma0_list,
                   n_segments: int = 3, seg_iters: int = 200,
                   nchains: int = 8, target_accept=(0.2, 0.5)):
    """Warm-up loop: run a segment, pool per-block acceptance across chains,
    rescale the proposal sigmas multiplicatively toward the target window
    (``rescale_sigmas``; purely multiplicative from the seed sigmas), and
    start the next segment at the pooled last state (the chains' mean last
    D_ell).  Returns the tuned sigmas, that warm start and the last
    segment's run output.

    make_scheme(prop_sigma_list) -> scheme with an MH C_ell step, called
    once when the scheme has ``set_proposal_sigmas`` (the scales are then
    swapped in place between segments, nothing rebuilt) and once per
    segment otherwise.  ``gen``: the torch.Generator every segment's
    ``run`` draws from."""
    sig = [np.asarray(s, dtype=np.float64) for s in sigma0_list]
    scheme, out = None, None
    for _ in range(n_segments):
        seg_sig = [s.copy() for s in sig]
        if scheme is not None and hasattr(scheme, "set_proposal_sigmas"):
            scheme.set_proposal_sigmas(seg_sig)
        else:
            scheme = make_scheme(seg_sig)
        out = scheme.run(dl_init_tuple, n_iter=seg_iters, nchains=nchains,
                         gen=gen)
        sig, _ = rescale_sigmas(sig, out, getattr(scheme, "blocks_list",
                                                  None), target_accept)
        dl_init_tuple = tuple(_host(c)[:, -1, :].mean(axis=0)
                              for c in out["dl_chains"])
    return sig, dl_init_tuple, out
