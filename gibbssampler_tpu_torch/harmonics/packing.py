"""Real-packed alm index maps (numpy; the part the grid-packed state needs).

A numpy copy of ``gibbssampler_tpu.harmonics.packing.index_maps`` restricted
to the per-slot degree/order/part tables.  The real packing is

- entries [0, lmax]: the m = 0 coefficients a_{l0}, l = 0..lmax
- then, m-major for m = 1..lmax, l = m..lmax, interleaved pairs
  (sqrt(2) Re a_{lm}, sqrt(2) Im a_{lm})

The port keeps its sampler state in the grid-packed layout
(``harmonics.gridstate``); these maps only define the flat <-> state
permutations stored beside the state masks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

__all__ = ["AlmIndexMaps", "index_maps", "nflat"]


def nflat(lmax: int) -> int:
    """Length of the real packing: (lmax+1)^2."""
    return (lmax + 1) ** 2


@dataclass(frozen=True)
class AlmIndexMaps:
    """Per flat slot: degree l, order m and whether it holds sqrt2*Im."""

    lmax: int
    ell_of: np.ndarray        # (nflat,) int32
    m_of: np.ndarray          # (nflat,) int32
    is_imag: np.ndarray       # (nflat,) bool


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
    return AlmIndexMaps(lmax=lmax, ell_of=ell_of, m_of=m_of, is_imag=is_imag)
