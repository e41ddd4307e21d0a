"""Power-spectrum conventions: D_ell <-> C_ell, variance expansion,
binning, empirical spectra and filters on the real (flat) packing, beams.

PyTorch counterpart of ``gibbssampler_tpu.harmonics.spectra``.  Functions
broadcast over leading batch axes (chains first); bins are static numpy
int arrays of ell breakpoints, bin b covering [bins[b], bins[b+1]).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .packing import index_maps

__all__ = ["device_constant", "dl_to_cl_factor", "dl_to_cl", "cl_to_dl",
           "variance_expansion", "variance_expansion_matrix", "bin_index",
           "unfold_bins", "bin_sum", "alm2cl", "almxfl", "gauss_beam"]

_DEVICE_CONSTANTS: dict = {}


def device_constant(key: tuple, make, dtype, device) -> torch.Tensor:
    """The constant table ``make()`` (a numpy array) on ``device`` in
    ``dtype``, copied there once and cached under ``key``: the iteration
    loop then makes no host-to-device copy (each of which would also wait
    for the stream).  Callers must not write into the result."""
    k = (key, dtype, torch.device(device))
    t = _DEVICE_CONSTANTS.get(k)
    if t is None:
        t = torch.as_tensor(np.asarray(make()), dtype=dtype, device=device)
        _DEVICE_CONSTANTS[k] = t
    return t


@functools.lru_cache(maxsize=None)
def _dl_to_cl_factor_np(lmax: int) -> np.ndarray:
    """scale[l] with C_l = D_l * scale[l]; scale[0] = scale[1] = 0 (the
    monopole and dipole are fixed to zero throughout)."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = 2.0 * np.pi / (ell * (ell + 1.0))
    scale[:2] = 0.0
    return scale


def dl_to_cl_factor(lmax: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    return device_constant(("dl_to_cl", lmax),
                           lambda: _dl_to_cl_factor_np(lmax), dtype,
                           device if device is not None else "cpu")


def dl_to_cl(dl: torch.Tensor, lmax: int | None = None) -> torch.Tensor:
    """D_ell -> C_ell = D_ell * 2 pi / (l (l+1)), with l = 0, 1 zeroed."""
    if lmax is None:
        lmax = dl.shape[-1] - 1
    return dl * dl_to_cl_factor(lmax, dl.dtype, dl.device)


def cl_to_dl(cl: torch.Tensor, lmax: int | None = None) -> torch.Tensor:
    """C_ell -> D_ell = l (l+1) C_ell / (2 pi)."""
    if lmax is None:
        lmax = cl.shape[-1] - 1
    ell = torch.arange(lmax + 1, dtype=cl.dtype, device=cl.device)
    return cl * ell * (ell + 1.0) / (2.0 * np.pi)


def _ell_of(lmax: int, device) -> torch.Tensor:
    """The degree of each slot of the real packing, on ``device``."""
    return device_constant(("ell_of", lmax), lambda: index_maps(lmax).ell_of,
                           torch.int64, device)


def variance_expansion(dl: torch.Tensor, lmax: int) -> torch.Tensor:
    """Per-slot prior variance of the real packing from D_ell: var[i] =
    C_l(i), (..., lmax+1) -> (..., (lmax+1)^2)."""
    return dl_to_cl(dl, lmax)[..., _ell_of(lmax, dl.device)]


def variance_expansion_matrix(dl_blocks: torch.Tensor,
                              lmax: int) -> torch.Tensor:
    """Per-slot k x k prior covariance blocks of the real packing from
    per-ell D_ell blocks: (..., lmax+1, k, k) -> (..., (lmax+1)^2, k, k),
    the C_ell block repeated over every (l, m) slot (the joint sampler's
    k x k variance expansion)."""
    scale = dl_to_cl_factor(lmax, dl_blocks.dtype, dl_blocks.device)
    cl_blocks = dl_blocks * scale[..., :, None, None]
    return cl_blocks[..., _ell_of(lmax, dl_blocks.device), :, :]


def bin_index(bins: np.ndarray, lmax: int) -> np.ndarray:
    """bin_of[l] for l = 0..lmax; ells outside [bins[0], bins[-1]) map to -1."""
    bins = np.asarray(bins)
    ells = np.arange(lmax + 1)
    idx = np.searchsorted(bins, ells, side="right") - 1
    idx[(ells < bins[0]) | (ells >= bins[-1])] = -1
    return idx.astype(np.int64)


def unfold_bins(binned: torch.Tensor, bins: np.ndarray,
                lmax: int) -> torch.Tensor:
    """(..., nbins) binned D_ell -> (..., lmax+1) per-ell D_ell; ells
    outside the binned range (the fixed monopole/dipole) get 0."""
    key = (lmax, np.asarray(bins, dtype=np.int64).tobytes())
    idx = lambda: bin_index(bins, lmax)
    src = device_constant(("unfold_src",) + key,
                          lambda: np.maximum(idx(), 0), torch.int64,
                          binned.device)
    keep = device_constant(("unfold_keep",) + key, lambda: idx() >= 0,
                           torch.bool, binned.device)
    return torch.where(keep, binned[..., src], 0.0)


def bin_sum(per_ell: torch.Tensor, bins: np.ndarray,
            lmax: int) -> torch.Tensor:
    """Sum per-ell values within each bin -> (..., nbins)."""
    key = ("bin_onehot", lmax, np.asarray(bins, dtype=np.int64).tobytes())
    onehot = lambda: (bin_index(bins, lmax)[:, None]
                      == np.arange(len(bins) - 1)[None, :])
    return per_ell @ device_constant(key, onehot, per_ell.dtype,
                                     per_ell.device)


def alm2cl(flat: torch.Tensor, lmax: int,
           flat2: torch.Tensor | None = None) -> torch.Tensor:
    """Empirical (pseudo-)spectrum of a real-packed alm vector, (...,
    lmax+1): hat C_l = 1/(2l+1) sum_m |a_lm|^2, which with the sqrt(2)
    packing is 1/(2l+1) times the sum of squares of the degree-l slots;
    the cross-spectrum with ``flat2``."""
    other = flat if flat2 is None else flat2
    prod = flat * other
    sums = torch.zeros(prod.shape[:-1] + (lmax + 1,), dtype=prod.dtype,
                       device=prod.device)
    sums.index_add_(-1, _ell_of(lmax, prod.device), prod)
    counts = device_constant(("counts", lmax),
                             lambda: 2.0 * np.arange(lmax + 1) + 1.0,
                             flat.dtype, flat.device)
    return sums / counts


def almxfl(flat: torch.Tensor, fl: torch.Tensor, lmax: int) -> torch.Tensor:
    """A real-packed alm times a per-ell filter fl (..., lmax+1)
    (healpy.almxfl's role)."""
    return flat * fl[..., _ell_of(lmax, flat.device)]


def gauss_beam(fwhm_radians: float, lmax: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Gaussian beam window b_l = exp(-l(l+1) sigma^2 / 2),
    sigma = fwhm / sqrt(8 ln 2) (healpy.gauss_beam equivalent)."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    sigma = fwhm_radians / np.sqrt(8.0 * np.log(2.0))
    return torch.as_tensor(np.exp(-0.5 * ell * (ell + 1.0) * sigma ** 2),
                           dtype=dtype, device=device)
