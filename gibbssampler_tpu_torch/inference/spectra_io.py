"""Theory-spectrum I/O (a copy of ``gibbssampler_tpu.inference.spectra_io``).

Boltzmann codes stay outside the sampler: spectra load from files
(CAMB/CLASS text or .npy / .npz) or come from the analytic toy of
``inference.simulate.example_dl``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_cls", "KCMB_UK"]

KCMB_UK = 2.7255e6   # CMB temperature in muK: the K -> muK factor


def load_cls(path: str, lmax: int, columns=("tt", "ee", "bb", "te"),
             input_is_dl: bool = True, k_to_uk: bool = False) -> dict:
    """Load theory spectra from a file.

    .npy / .npz : array (ncols, lmax+1) or dict of named arrays
    .txt / .dat : CAMB-style text, first column ell, then the named columns

    Returns dict name -> (lmax+1,) D_ell array (muK^2), monopole/dipole
    zeroed.  input_is_dl=False converts C_ell -> D_ell; k_to_uk applies the
    (2.7255e6)^2 unit conversion of dimensionless CLASS output."""
    if path.endswith(".npz"):
        z = np.load(path)
        raw = {k: np.asarray(z[k], dtype=np.float64) for k in z.files}
    elif path.endswith(".npy"):
        arr = np.load(path)
        raw = {c: np.asarray(arr[i], dtype=np.float64)
               for i, c in enumerate(columns[: arr.shape[0]])}
    else:
        data = np.loadtxt(path)
        ells = data[:, 0].astype(int)
        raw = {}
        for i, c in enumerate(columns[: data.shape[1] - 1]):
            full = np.zeros(int(ells.max()) + 1)
            full[ells] = data[:, i + 1]
            raw[c] = full
    out = {}
    for name, arr in raw.items():
        dl = np.zeros(lmax + 1)
        n = min(lmax + 1, arr.shape[0])
        dl[:n] = arr[:n]
        if not input_is_dl:
            ell = np.arange(lmax + 1, dtype=np.float64)
            dl = dl * ell * (ell + 1.0) / (2.0 * np.pi)
        if k_to_uk:
            dl = dl * KCMB_UK ** 2
        dl[:2] = 0.0
        out[name] = dl
    return out
