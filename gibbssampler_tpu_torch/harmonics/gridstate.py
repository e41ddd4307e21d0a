"""Grid-packed alm state layout (PyTorch counterpart of
``gibbssampler_tpu.harmonics.gridstate``).

The layout is kept exactly, so arrays of the two packages compare without
repacking:

    state : real tensor (..., nstate),  nstate = 2 (lmax+1)^2
    state.reshape(..., 2, L, L)[p, m, l] =
        p = 0:  a_{l0}            if m = 0
                sqrt(2) Re a_{lm} if m > 0
        p = 1:  0                 if m = 0
                sqrt(2) Im a_{lm} if m > 0
    slots with l < m are 0 (invalid).

Every valid slot of a field with spectrum C_ell has prior variance exactly
C_ell, so variance expansion is a broadcast and the conditional samplers
stay elementwise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .packing import index_maps, nflat
from .spectra import device_constant, dl_to_cl

__all__ = [
    "nstate",
    "state_masks",
    "expand_cl_state",
    "variance_expansion_state",
    "almxfl_state",
    "alm2cl_state",
    "ell_mask_state",
    "flat_to_state",
    "state_to_flat",
]

_SQRT2 = np.sqrt(2.0)
_INV_SQRT2 = 1.0 / np.sqrt(2.0)


def nstate(lmax: int) -> int:
    """Length of the grid-packed state vector: 2 (lmax+1)^2."""
    return 2 * (lmax + 1) ** 2


class _StateMasks:
    """Numpy float64 constants for one lmax (cast at use sites)."""

    def __init__(self, lmax: int):
        L = lmax + 1
        m = np.arange(L)[:, None]
        l = np.arange(L)[None, :]
        tri = (l >= m)
        valid_re = tri
        valid_im = tri & (m > 0)
        self.valid = np.stack([valid_re, valid_im]).astype(np.float64)
        # state -> true Re/Im grids (the SHT's internal values)
        self.in_scale = np.stack([
            np.where(m > 0, _INV_SQRT2, 1.0) * valid_re,
            np.full((L, L), _INV_SQRT2) * valid_im,
        ])
        # true Re/Im grids -> state (the exact transpose's diagonal)
        self.out_scale = np.stack([
            np.where(m > 0, _SQRT2, 1.0) * valid_re,
            np.full((L, L), _SQRT2) * valid_im,
        ])
        # flat <-> state permutations
        maps = index_maps(lmax)
        part = maps.is_imag.astype(np.int64)
        state_of_flat = (part * L * L + maps.m_of.astype(np.int64) * L
                         + maps.ell_of.astype(np.int64))
        self.state_of_flat = state_of_flat.astype(np.int32)
        flat_of_state = np.zeros(2 * L * L, dtype=np.int64)
        flat_of_state[state_of_flat] = np.arange(nflat(lmax))
        self.flat_of_state = flat_of_state.astype(np.int32)
        self.state_valid_flat = self.valid.reshape(-1)
        self.lmax = lmax


@functools.lru_cache(maxsize=None)
def state_masks(lmax: int) -> _StateMasks:
    return _StateMasks(lmax)


def expand_cl_state(cl: torch.Tensor, lmax: int) -> torch.Tensor:
    """Per-ell values (..., lmax+1) -> per-slot values (..., nstate);
    invalid slots get 0."""
    L = lmax + 1
    valid = device_constant(("valid", lmax), lambda: state_masks(lmax).valid,
                            cl.dtype, cl.device)
    out = cl[..., None, None, :] * valid
    return out.reshape(cl.shape[:-1] + (2 * L * L,))


def variance_expansion_state(dl: torch.Tensor, lmax: int) -> torch.Tensor:
    """Per-slot prior variance from D_ell: var[slot] = C_{l(slot)}."""
    return expand_cl_state(dl_to_cl(dl, lmax), lmax)


def almxfl_state(x: torch.Tensor, fl: torch.Tensor, lmax: int) -> torch.Tensor:
    """Multiply a grid-packed alm state by a per-ell filter fl (..., lmax+1)."""
    L = lmax + 1
    g = x.reshape(x.shape[:-1] + (2, L, L))
    return (g * fl[..., None, None, :]).reshape(x.shape)


def alm2cl_state(x: torch.Tensor, lmax: int,
                 y: torch.Tensor | None = None) -> torch.Tensor:
    """Empirical (pseudo-)spectrum of a grid-packed state, (..., lmax+1):
    hat C_l = 1/(2l+1) sum over the valid slots of degree l of x*y."""
    L = lmax + 1
    other = x if y is None else y
    prod = (x * other).reshape(x.shape[:-1] + (2, L, L))
    sums = prod.sum(dim=(-3, -2))
    counts = device_constant(("counts", lmax),
                             lambda: 2.0 * np.arange(L) + 1.0, x.dtype,
                             x.device)
    return sums / counts


def ell_mask_state(lmax: int, lmin: int = 2, dtype=np.float64) -> np.ndarray:
    """(nstate,) numpy mask: 1 on valid slots with l >= lmin, else 0."""
    sm = state_masks(lmax)
    lsel = (np.arange(lmax + 1) >= lmin).astype(np.float64)
    return (sm.valid * lsel[None, None, :]).reshape(-1).astype(dtype)


def flat_to_state(flat: torch.Tensor, lmax: int) -> torch.Tensor:
    """Real (ragged) packing (..., (lmax+1)^2) -> grid-packed state
    (..., nstate), a gather at the boundary; invalid slots get 0."""
    sm = state_masks(lmax)
    src = device_constant(("flat_of_state", lmax), lambda: sm.flat_of_state,
                          torch.int64, flat.device)
    valid = device_constant(("valid_flat", lmax),
                            lambda: sm.state_valid_flat, flat.dtype,
                            flat.device)
    return flat[..., src] * valid


def state_to_flat(x: torch.Tensor, lmax: int) -> torch.Tensor:
    """Grid-packed state (..., nstate) -> real (ragged) packing (...,
    (lmax+1)^2), a gather at the boundary."""
    idx = device_constant(("state_of_flat", lmax),
                          lambda: state_masks(lmax).state_of_flat,
                          torch.int64, x.device)
    return x[..., idx]
