"""Dataset simulation on the Gauss-Legendre or HEALPix grid (PyTorch
counterpart of ``gibbssampler_tpu.inference.simulate``): theory D_ell ->
beam-smoothed Gaussian sky -> white noise -> optional mask, drawn from an
explicit ``torch.Generator``.  Fields are uncorrelated, or drawn from
per-ell covariance blocks (``dl_blocks``: a nonzero TE of joint TQU
data)."""

from __future__ import annotations

import numpy as np
import torch

from ..harmonics.gridstate import almxfl_state, variance_expansion_state
from ..harmonics.spectra import gauss_beam
from ..ops.model import SkyModel
from ..ops.noise import NoiseModel
from ..samplers.joint import synfast_joint
from ..sht.healpix import HealpixSHT
from ..sht.transform import SHT, make_sht

__all__ = ["example_dl", "synfast", "simulate_dataset"]


def example_dl(lmax: int, kind: str = "tt", amp: float = 1000.0) -> np.ndarray:
    """A CMB-like D_ell toy spectrum (muK^2) with damped acoustic
    structure; any positive spectrum exercises the same code paths."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    x = ell / 220.0
    osc = 1.0 + 0.6 * np.cos(np.pi * x)
    damp = np.exp(-((ell / (0.8 * max(lmax, 2))) ** 2))
    sw = (1.0 + x) ** -1.2
    dl = amp * sw * osc * damp + 1e-3 * amp
    if kind == "ee":
        dl = 0.01 * dl * (ell / 100.0) ** 2 / (1.0 + (ell / 100.0) ** 2)
        dl += 1e-5 * amp
    elif kind == "bb":
        dl = 1e-4 * amp * (ell / 80.0) ** 2 / (1.0 + (ell / 80.0) ** 4)
        dl += 1e-6 * amp
    dl[:2] = 0.0
    return dl


def synfast(dl_fields, sht: SHT | HealpixSHT, spin: int,
            gen: torch.Generator | None = None, xi=None):
    """Draw a Gaussian sky, alm ~ N(0, C_l) per field, and return (alm,
    maps) on the transform's device (healpy's synfast role).

    dl_fields: (nfields, lmax+1) D_ell.  spin 0: alm (1, nstate), maps (1,
    *pix), the T map; spin 2: (E, B) alm (2, nstate) and (Q, U) maps (2,
    *pix).  ``xi``: optional injected N(0, 1) variates (nfields, nstate);
    otherwise drawn from ``gen``."""
    if spin not in (0, 2):
        raise ValueError(f"spin={spin}: synfast draws spin 0 or 2 skies "
                         "(samplers.synfast_joint draws correlated TQU)")
    lmax, dt, dev = sht.lmax, sht.dtype, sht.device
    dl = torch.as_tensor(np.asarray(dl_fields), dtype=dt, device=dev)
    var = variance_expansion_state(dl, lmax)
    if xi is None:
        xi = torch.randn(var.shape, generator=gen, dtype=dt, device=dev)
    alm = torch.sqrt(var) * torch.as_tensor(xi, dtype=dt, device=dev)
    if spin == 0:
        return alm, sht.synthesis_state(alm[0])[None]
    return alm, torch.stack(sht.synthesis_spin2_state(alm[0], alm[1]))


def simulate_dataset(lmax: int, spin: int, dl_fields, noise_sigma2,
                     fwhm_radians: float = 0.0, mask=None,
                     dtype=torch.float32, device="cuda",
                     sht: SHT | HealpixSHT | None = None,
                     gen: torch.Generator | None = None, dl_blocks=None):
    """Simulate d = A B s + n and return (SkyModel, truth dict).

    dl_fields: (nfields, lmax+1) D_ell (spin 0: T; spin 2: E, B; spin 3:
    T, E, B); mask: optional (nrings, nphi) on an iso-latitude grid, or
    (npix,) in RING order on HEALPix (in either map layout; the padded
    layout takes it through ``from_ring``).  dl_blocks: optional (lmax+1,
    nfields, nfields) per-ell D_ell covariance blocks, whose diagonal must
    equal dl_fields: the fields are then drawn correlated
    (``samplers.synfast_joint``).  The sky is drawn from ``gen`` first,
    the noise after it."""
    if sht is None:
        sht = make_sht(lmax, dtype=dtype, spin2=(spin >= 2), device=device)
    dev = sht.device
    bl = (gauss_beam(fwhm_radians, lmax, dtype=dtype, device=dev)
          if fwhm_radians > 0 else torch.ones(lmax + 1, dtype=dtype, device=dev))
    nf = {0: 1, 2: 2, 3: 3}[spin]
    mask_t = (None if mask is None
              else torch.as_tensor(np.array(mask), dtype=dtype, device=dev))
    if isinstance(sht, HealpixSHT):
        noise = NoiseModel.white_healpix(noise_sigma2, sht.geo, nfields=nf,
                                         mask=mask, dtype=dtype, sht=sht,
                                         device=dev)
        if mask_t is not None and sht.layout == "padded":
            mask_t = sht.from_ring(mask_t)
    else:
        noise = NoiseModel.white(noise_sigma2, sht.grid, nfields=nf,
                                 mask=mask, dtype=dtype, device=dev)
    dl = torch.as_tensor(np.asarray(dl_fields), dtype=dtype, device=dev)
    if dl_blocks is not None:
        ell = np.arange(lmax + 1, dtype=np.float64)
        cl_fac = np.where(ell >= 2, 2.0 * np.pi / np.maximum(
            ell * (ell + 1.0), 1.0), 0.0)
        blocks = torch.as_tensor(np.asarray(dl_blocks) * cl_fac[:, None, None],
                                 dtype=dtype, device=dev)
        alm_true = synfast_joint(blocks, lmax, dtype=dtype, device=dev,
                                 gen=gen)
    else:
        var = variance_expansion_state(dl, lmax)
        alm_true = torch.sqrt(var) * torch.randn(var.shape, generator=gen,
                                                 dtype=dtype, device=dev)
    model = SkyModel(sht=sht, noise=noise, bl=bl, spin=spin)
    sky = model.forward(alm_true)
    inv = noise.inv_noise
    std = torch.where(inv > 0, 1.0 / torch.sqrt(torch.where(inv > 0, inv, 1.0)),
                      0.0)
    d = sky + std * torch.randn(sky.shape, generator=gen, dtype=dtype,
                                device=dev)
    if mask_t is not None:
        d = d * mask_t
    model = SkyModel(sht=sht, noise=noise, bl=bl, spin=spin, d=d)
    truth = {"alm_true": alm_true, "dl_true": dl, "sky": sky}
    if dl_blocks is not None:
        truth["dl_blocks_true"] = torch.as_tensor(
            np.asarray(dl_blocks), dtype=dtype, device=dev)
    return model, truth
