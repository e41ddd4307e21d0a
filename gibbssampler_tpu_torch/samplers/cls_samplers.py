"""Power-spectrum conditional samplers: the binned conjugate inverse-gamma
draw of the centered scheme (PyTorch counterpart of
``gibbssampler_tpu.samplers.cls_samplers.invgamma_dl`` and
``centered_cls_sample``).

The gamma variates come from ``standard_gamma``, a Marsaglia-Tsang
rejection sampler written on ``torch.randn`` / ``torch.rand`` with an
explicit ``torch.Generator`` (``torch.distributions.Gamma.sample`` takes
none), or are injected, so that a test can feed both packages the same
numbers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..harmonics.gridstate import alm2cl_state
from ..harmonics.spectra import bin_sum

__all__ = ["standard_gamma", "invgamma_dl", "centered_cls_sample"]


def standard_gamma(alpha: torch.Tensor, gen=None) -> torch.Tensor:
    """Gamma(alpha, 1) variates of alpha's shape for alpha >= 1 (Marsaglia
    & Tsang 2000; the conjugate draw's shapes are all >= 1.5).

    d = alpha - 1/3, c = 1/sqrt(9 d); propose v = (1 + c z)^3, z ~ N(0,1),
    accept when log U < z^2/2 + d - d v + d log v.  Each round proposes for
    every element still pending (acceptance >= 95%), so a few rounds
    suffice; one host sync per round."""
    if bool((alpha < 1.0).any()):
        raise ValueError("standard_gamma needs alpha >= 1")
    a = alpha
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    pending = torch.ones_like(a, dtype=torch.bool)
    while bool(pending.any()):
        z = torch.randn(a.shape, generator=gen, dtype=a.dtype, device=a.device)
        u = torch.rand(a.shape, generator=gen, dtype=a.dtype, device=a.device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        take = pending & ok
        out = torch.where(take, d * v, out)
        pending = pending & ~ok
    return out


def invgamma_dl(s_flat: torch.Tensor, bins: np.ndarray, lmax: int,
                gamma: torch.Tensor | None = None, gen=None) -> torch.Tensor:
    """Binned conjugate draw for one field, (..., nstate) -> (..., nbins).

    beta_bin = sum_l (2l+1) l(l+1) hat-C_l / (4 pi),
    alpha_bin = sum_l (2l+1)/2 - 1 (clamped to 1 where <= 0),
    D_bin = beta_bin / Gamma(alpha_bin).  ``gamma``: optional injected
    Gamma(alpha_bin) variates of the output's shape."""
    dt = s_flat.dtype
    cl_hat = alm2cl_state(s_flat, lmax)
    ell = torch.arange(lmax + 1, dtype=dt, device=s_flat.device)
    beta_l = (2.0 * ell + 1.0) * ell * (ell + 1.0) * cl_hat / (4.0 * np.pi)
    beta = bin_sum(beta_l, bins, lmax)
    alpha = bin_sum(2.0 * ell + 1.0, bins, lmax) / 2.0 - 1.0
    alpha = torch.where(alpha <= 0, 1.0, alpha)
    if gamma is None:
        gamma = standard_gamma(alpha.expand(beta.shape), gen)
    return beta / gamma


def centered_cls_sample(s: torch.Tensor, bins_list: Sequence[np.ndarray],
                        lmax: int, gammas=None, gen=None):
    """Independent binned inverse-gamma draws per field.  s: (...,
    nfields, nstate).  Returns a tuple of per-field (..., nbins_f) binned
    D_ell; ``gammas`` optionally injects one variate tensor per field."""
    if gammas is None:
        gammas = (None,) * len(bins_list)
    return tuple(invgamma_dl(s[..., f, :], bins, lmax, gamma=g, gen=gen)
                 for f, (bins, g) in enumerate(zip(bins_list, gammas)))
