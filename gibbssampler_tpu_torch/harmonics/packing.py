"""Real-packed alm conventions and index maps (PyTorch counterpart of
``gibbssampler_tpu.harmonics.packing``; the index tables are a numpy copy).

The real packing of a real field's alm is a vector of length (lmax+1)^2:

- entries [0, lmax]: the m = 0 coefficients a_{l0}, l = 0..lmax
- then, m-major for m = 1..lmax, l = m..lmax, interleaved pairs
  (sqrt(2) Re a_{lm}, sqrt(2) Im a_{lm})

With the sqrt(2) scaling every real coefficient of a field with spectrum
C_ell has variance C_ell.  The maps below convert between

- ``flat``  : the real packing, (..., (lmax+1)^2)
- ``grid``  : (re, im) arrays indexed [m, l], (..., lmax+1, lmax+1), zero
              where l < m
- ``healpy``: complex alm in healpy's order idx = m (2 lmax + 1 - m)/2 + l,
              (..., (lmax+1)(lmax+2)/2), for interop.

The port keeps its sampler state in the grid-packed layout
(``harmonics.gridstate``); every function here is a gather at the
boundary, on the input's device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["AlmIndexMaps", "index_maps", "nflat", "nhealpy", "flat_to_grid",
           "grid_to_flat", "flat_to_healpy", "healpy_to_flat"]

_SQRT2 = np.sqrt(2.0)
_INV_SQRT2 = 1.0 / np.sqrt(2.0)


def nflat(lmax: int) -> int:
    """Length of the real packing: (lmax+1)^2."""
    return (lmax + 1) ** 2


def nhealpy(lmax: int) -> int:
    """Number of complex alm in healpy's triangular order."""
    return (lmax + 1) * (lmax + 2) // 2


@dataclass(frozen=True)
class AlmIndexMaps:
    """Static index tables for one lmax (numpy)."""

    lmax: int
    # per flat slot: degree l, order m and whether it holds sqrt2*Im
    ell_of: np.ndarray        # (nflat,) int32
    m_of: np.ndarray          # (nflat,) int32
    is_imag: np.ndarray       # (nflat,) bool
    # flat -> grid: the flat slot feeding grid[m, l] re / im, and its scale
    grid_re_src: np.ndarray   # (L, L) int32
    grid_im_src: np.ndarray   # (L, L) int32
    grid_re_scale: np.ndarray  # (L, L) float64: 1, 1/sqrt2 or 0
    grid_im_scale: np.ndarray
    # grid -> flat: 1 for m = 0, sqrt2 otherwise
    flat_scale: np.ndarray    # (nflat,)
    # healpy interop
    hp_of_flat: np.ndarray    # (nflat,) int32 healpy index of slot i
    hp_ell: np.ndarray        # (nhealpy,) int32
    hp_m: np.ndarray          # (nhealpy,) int32


@functools.lru_cache(maxsize=None)
def index_maps(lmax: int) -> AlmIndexMaps:
    L = lmax + 1
    n = nflat(lmax)
    ell_of = np.zeros(n, dtype=np.int32)
    m_of = np.zeros(n, dtype=np.int32)
    is_imag = np.zeros(n, dtype=bool)
    ell_of[:L] = np.arange(L)
    pos = L
    for m in range(1, L):
        nl = L - m
        ells = np.arange(m, L)
        ell_of[pos: pos + 2 * nl: 2] = ells
        ell_of[pos + 1: pos + 2 * nl: 2] = ells
        m_of[pos: pos + 2 * nl] = m
        is_imag[pos + 1: pos + 2 * nl: 2] = True
        pos += 2 * nl
    assert pos == n
    re_slot = np.zeros((L, L), dtype=np.int64)
    im_slot = np.zeros((L, L), dtype=np.int64)
    grid_re_scale = np.zeros((L, L))
    grid_im_scale = np.zeros((L, L))
    re_slot[0, :] = np.arange(L)
    grid_re_scale[0, :] = 1.0
    pos = L
    for m in range(1, L):
        for l in range(m, L):
            re_slot[m, l] = pos
            im_slot[m, l] = pos + 1
            grid_re_scale[m, l] = _INV_SQRT2
            grid_im_scale[m, l] = _INV_SQRT2
            pos += 2
    hp_of_flat = (m_of.astype(np.int64) * (2 * lmax + 1 - m_of) // 2
                  + ell_of).astype(np.int32)
    nh = nhealpy(lmax)
    hp_ell = np.zeros(nh, dtype=np.int32)
    hp_m = np.zeros(nh, dtype=np.int32)
    for m in range(L):
        base = m * (2 * lmax + 1 - m) // 2
        hp_ell[base + m: base + L] = np.arange(m, L)
        hp_m[base + m: base + L] = m
    return AlmIndexMaps(
        lmax=lmax, ell_of=ell_of, m_of=m_of, is_imag=is_imag,
        grid_re_src=re_slot.astype(np.int32),
        grid_im_src=im_slot.astype(np.int32),
        grid_re_scale=grid_re_scale, grid_im_scale=grid_im_scale,
        flat_scale=np.where(m_of == 0, 1.0, _SQRT2), hp_of_flat=hp_of_flat,
        hp_ell=hp_ell, hp_m=hp_m)


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def flat_to_grid(flat: torch.Tensor, lmax: int):
    """Real packing (..., (lmax+1)^2) -> (re, im) grids, each (...,
    lmax+1, lmax+1): re[m, l] = Re a_lm, im[m, l] = Im a_lm, zero where
    l < m."""
    maps = index_maps(lmax)
    dev, dt = flat.device, flat.dtype
    re = flat[..., _idx(maps.grid_re_src, dev)] * torch.as_tensor(
        maps.grid_re_scale, dtype=dt, device=dev)
    im = flat[..., _idx(maps.grid_im_src, dev)] * torch.as_tensor(
        maps.grid_im_scale, dtype=dt, device=dev)
    return re, im


def grid_to_flat(re: torch.Tensor, im: torch.Tensor,
                 lmax: int) -> torch.Tensor:
    """Inverse of :func:`flat_to_grid`."""
    maps = index_maps(lmax)
    dev = re.device
    m_of, ell_of = _idx(maps.m_of, dev), _idx(maps.ell_of, dev)
    is_imag = torch.as_tensor(maps.is_imag, device=dev)
    scale = torch.as_tensor(maps.flat_scale, dtype=re.dtype, device=dev)
    return torch.where(is_imag, im[..., m_of, ell_of],
                       re[..., m_of, ell_of]) * scale


def flat_to_healpy(flat: torch.Tensor, lmax: int) -> torch.Tensor:
    """Real packing -> complex alm in healpy's order."""
    re, im = flat_to_grid(flat, lmax)
    maps = index_maps(lmax)
    hm, hl = _idx(maps.hp_m, flat.device), _idx(maps.hp_ell, flat.device)
    return torch.complex(re[..., hm, hl], im[..., hm, hl])


def healpy_to_flat(alm: torch.Tensor, lmax: int) -> torch.Tensor:
    """Complex alm in healpy's order -> real packing."""
    maps = index_maps(lmax)
    dev = alm.device
    vals = alm[..., _idx(maps.hp_of_flat, dev)]
    is_imag = torch.as_tensor(maps.is_imag, device=dev)
    scale = torch.as_tensor(maps.flat_scale, dtype=vals.real.dtype,
                            device=dev)
    return torch.where(is_imag, vals.imag, vals.real) * scale
