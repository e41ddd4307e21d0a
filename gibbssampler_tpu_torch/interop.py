"""Carry a dataset and sampler state of the JAX package across to the port.

The JAX model's fields arrive as plain numpy arrays (the caller converts
them with ``np.asarray``), so this module needs no jax.  The port rebuilds
its own operator tables from the grid; ``ops.with_cut_decomposition`` then
recomputes the cut rows the same way the JAX package does.

    arrays = {"d": ..., "tau": ..., "q_map": ..., "omega": float,
              "bl": ..., "spin": int, "theta": ..., "weights": ...,
              "phi0": ..., "nphi": int}

A HEALPix model gives the grid as {"grid": "healpix", "nside": int,
"layout": "ring" | "padded"} in place of theta, weights, phi0 and nphi;
its maps are flat vectors in that layout.  ``spin`` is 0, 2 or 3 (joint
TQU).

``tuned_proposal_sigmas`` reads the tuned MH proposal scales that the JAX
package's tuning run stored in ``tuned_proposals.json``;
``port_tuned_proposal_sigmas`` reads the port's own records
(``gibbssampler_tpu_torch/tuned_proposals.json``, written by
``python -m gibbssampler_tpu_torch.tune``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .ops.model import SkyModel
from .ops.noise import NoiseModel
from .schemes.gibbs import GibbsState
from .schemes.joint_scheme import JointState
from .sht.grids import SphereGrid
from .sht.healpix import make_healpix_sht
from .sht.transform import SHT

__all__ = ["model_from_numpy", "state_from_numpy", "tuned_proposal_sigmas",
           "port_tuned_proposal_sigmas", "RECORD_KEYS", "record_key"]


def model_from_numpy(arrays: dict, device="cuda",
                     dtype=torch.float64) -> SkyModel:
    """Build the port's SkyModel (full grid, no cut decomposition) from the
    JAX model's fields given as numpy arrays.  The transform's options,
    where given: "table_dtype", "m_block", "ring_split" and, on a
    quadrature grid, "fft_mode" (``SHT``'s defaults otherwise)."""
    spin = int(arrays["spin"])
    bl = np.asarray(arrays["bl"])
    lmax = bl.shape[0] - 1
    opts = {k: arrays[k] for k in ("table_dtype", "m_block", "ring_split")
            if k in arrays}
    if arrays.get("grid") == "healpix":
        sht = make_healpix_sht(int(arrays["nside"]), lmax, dtype=dtype,
                               spin2=(spin >= 2),
                               layout=arrays.get("layout", "ring"),
                               device=device, **opts)
    else:
        grid = SphereGrid(
            name="interop",
            theta=np.asarray(arrays["theta"], dtype=np.float64),
            weights=np.asarray(arrays["weights"], dtype=np.float64),
            nphi=int(arrays["nphi"]),
            phi0=np.asarray(arrays["phi0"], dtype=np.float64))
        sht = SHT(grid, lmax, dtype=dtype, spin2=(spin >= 2), device=device,
                  fft_mode=arrays.get("fft_mode", "matmul"), **opts)
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    noise = NoiseModel(tau=t(arrays["tau"]), q_map=t(arrays["q_map"]),
                       omega=float(arrays["omega"]))
    d = arrays.get("d")
    return SkyModel(sht=sht, noise=noise, bl=t(bl), spin=spin,
                    d=None if d is None else t(d))


def state_from_numpy(s, dl=None, device="cuda", dtype=torch.float64,
                     cl=None):
    """GibbsState from (nchains, nfields, nstate) ``s`` and a per-field
    sequence ``dl`` of (nchains, nbins_f) binned D_ell; or, given ``cl``
    (nchains, lmax+1, k, k) C_ell blocks in place of ``dl``, the joint
    scheme's JointState."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    if cl is not None:
        return JointState(s=t(s), cl=t(cl))
    return GibbsState(s=t(s), dl=tuple(t(x) for x in dl))


def _records(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data.get("records", [data]) if isinstance(data, dict) else data


def tuned_proposal_sigmas(path, scheme: str, grid: str, lmax: int,
                          nbins) -> list:
    """The per-field proposal std devs of the record of ``path`` (a
    ``tuned_proposals.json``) whose scheme, grid, lmax and per-field bin
    counts all match, as float64 arrays: the match rule of ``bench.py``.
    Raises ``LookupError`` when no record matches; it never falls back to
    another scale."""
    want = [int(n) for n in nbins]
    for rec in _records(path):
        if (rec.get("scheme") == scheme and rec.get("grid") == grid
                and rec.get("lmax") == lmax and rec.get("nbins") == want):
            return [np.asarray(x, dtype=np.float64) for x in rec["sig"]]
    raise LookupError(f"{path}: no tuned proposal record for scheme "
                      f"{scheme!r}, grid {grid!r}, lmax {lmax}, nbins {want}")


# the fields that identify one of the port's tuned records
RECORD_KEYS = ("scheme", "grid", "mask", "lmax", "nbins", "cr", "l_cut")


def record_key(scheme: str, grid: str, mask: str, lmax: int, nbins,
               cr: str, l_cut=None) -> dict:
    """The identifying fields (``RECORD_KEYS``) of one of the port's tuned
    records; ``l_cut`` (PNCP, one value per field) is None for ASIS."""
    return dict(zip(RECORD_KEYS, (scheme, grid, mask, int(lmax),
                                  [int(n) for n in nbins], cr,
                                  None if l_cut is None
                                  else [int(c) for c in l_cut])))


def port_tuned_proposal_sigmas(path, scheme: str, grid: str, mask: str,
                               lmax: int, nbins, cr: str,
                               l_cut=None) -> list:
    """The per-field proposal std devs of the port's record of ``path``
    whose scheme, grid, mask, lmax, per-field bin counts, CR method and
    l_cut all match (a record without l_cut has None), as float64 arrays.
    Raises ``LookupError`` when none matches; it never falls back to
    another record or scale."""
    key = record_key(scheme, grid, mask, lmax, nbins, cr, l_cut)
    for rec in _records(path):
        if all(rec.get(k) == v for k, v in key.items()):
            return [np.asarray(x, dtype=np.float64) for x in rec["sig"]]
    raise LookupError(f"{path}: no tuned proposal record for {key}")
