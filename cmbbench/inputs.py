"""What the benchmark makes from a configuration and a seed, before the
measured program sees it: the pixelization, the mask, the beam, the
fiducial spectrum and bins, the observed (Q, U) maps and the start.

Nothing here comes from the measured package.  The maps are drawn on the
device from the configuration's ``data_seed`` (the same dataset in every
run; a run's ``--seed`` drives its chains): an alm state from the fiducial
spectrum, synthesized
by the benchmark's own transform (``reference.sphere``), beam-smoothed,
plus white noise of variance sigma^2 per unit of the mean pixel area,
times the mask (bench.py's recipe: noise variance 1 / (tau q) with
tau = mask / sigma^2 and q the pixel's area over the mean).  Pixels are
numbered ring after ring from the north pole, each ring from its first
azimuth (HEALPix RING order; on the Gauss-Legendre grid the same with
phi0 = 0).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference.sphere import FullRings, state_valid

__all__ = ["Pixelization", "pixelization", "make_mask", "beam",
           "fiducial_dl", "binned_mean", "cl_factor", "simulate",
           "sky_synth", "sky_adjoint", "gamma_alpha", "start_dl"]

# rings whose tables are built at once by the full-sky transforms (bounds
# the float64 tables of a chunk, (2, L, L, rings), to about 1 GB at lmax 512)
_SKY_CHUNK = 128


@dataclass(frozen=True)
class Pixelization:
    """Rings of a sphere pixelization: colatitude, ring length, azimuth of
    the first pixel, index of the ring's first pixel, and each ring's pixel
    area over the mean pixel area (``q``); ``omega`` = 4 pi / npix."""

    theta: np.ndarray
    nphi: np.ndarray
    phi0: np.ndarray
    start: np.ndarray
    q: np.ndarray
    omega: float

    @property
    def npix(self) -> int:
        return int(self.nphi.sum())

    def ring_of_pixel(self) -> np.ndarray:
        return np.repeat(np.arange(self.theta.size), self.nphi)

    def phi_of_pixel(self) -> np.ndarray:
        r = self.ring_of_pixel()
        j = np.arange(self.npix) - self.start[r]
        return self.phi0[r] + 2.0 * np.pi * j / self.nphi[r]

    def locate(self, theta, phi) -> np.ndarray:
        """Pixel indices of points given by (colatitude, azimuth); raises
        unless each point lies on a pixel centre."""
        theta = np.asarray(theta, np.float64)
        phi = np.asarray(phi, np.float64)
        r = np.searchsorted(self.theta, theta)
        r = np.clip(r, 0, self.theta.size - 1)
        rm = np.clip(r - 1, 0, self.theta.size - 1)
        r = np.where(np.abs(self.theta[rm] - theta)
                     < np.abs(self.theta[r] - theta), rm, r)
        if np.abs(self.theta[r] - theta).max(initial=0.0) > 1e-9:
            raise ValueError("a point lies off the pixelization's rings")
        step = 2.0 * np.pi / self.nphi[r]
        j = np.rint((phi - self.phi0[r]) / step).astype(np.int64)
        off = phi - (self.phi0[r] + j * step)
        if np.abs(off).max(initial=0.0) > 1e-9:
            raise ValueError("a point lies off the pixel centres")
        return self.start[r] + np.mod(j, self.nphi[r])


def _gl(lmax: int) -> Pixelization:
    x, w = np.polynomial.legendre.leggauss(lmax + 1)
    order = np.argsort(-x)
    nr, nphi = lmax + 1, 2 * lmax + 2
    omega = 4.0 * np.pi / (nr * nphi)
    return Pixelization(
        theta=np.arccos(x[order]), nphi=np.full(nr, nphi),
        phi0=np.zeros(nr), start=np.arange(nr) * nphi,
        q=w[order] * (2.0 * np.pi / nphi) / omega, omega=omega)


def _healpix(nside: int) -> Pixelization:
    """HEALPix RING rings (Gorski et al. 2005): caps of 4 i pixels at
    z = +-(1 - i^2 / (3 nside^2)), the belt of 4 nside pixels at
    z = 4/3 - 2 i / (3 nside), shifted by half a pixel on alternate rings."""
    i = np.arange(1, 4 * nside)
    ic = np.minimum(i, 4 * nside - i)
    cap = ic < nside
    z = np.where(cap, 1.0 - ic ** 2 / (3.0 * nside ** 2),
                 4.0 / 3.0 - 2.0 * ic / (3.0 * nside))
    z = np.where(i > 2 * nside, -z, z)
    nphi = np.where(cap, 4 * ic, 4 * nside)
    shift = np.where(cap, 1.0, ((i - nside + 1) % 2).astype(np.float64))
    phi0 = np.pi / nphi * shift
    start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    npix = 12 * nside * nside
    return Pixelization(theta=np.arccos(z), nphi=nphi, phi0=phi0,
                        start=start, q=np.ones(i.size),
                        omega=4.0 * np.pi / npix)


def pixelization(cfg: dict) -> Pixelization:
    grid = cfg["grid"]
    if grid["kind"] == "gl":
        return _gl(cfg["lmax"])
    if grid["kind"] == "healpix":
        return _healpix(grid["nside"])
    raise ValueError(f"grid kind {grid['kind']!r}; gl or healpix")


def make_mask(cfg: dict, pix: Pixelization) -> np.ndarray:
    """The configuration's mask per pixel, in [0, 1]: "band" keeps
    |latitude| > ``band_rad``; "planckish" is bench.py's apodized band
    (cosine ramp of ``apo_deg`` from ``band_deg``) with ``nholes`` holes of
    ``hole_deg`` radius, centres drawn from numpy's default_rng(``seed``)
    (bench.py:160-213)."""
    mk = cfg["mask"]
    r = pix.ring_of_pixel()
    theta = pix.theta[r]
    lat = np.abs(np.pi / 2 - theta)
    if mk["kind"] == "band":
        return (lat > mk["band_rad"]).astype(np.float64)
    if mk["kind"] != "planckish":
        raise ValueError(f"mask kind {mk['kind']!r}; band or planckish")
    x = np.clip((lat - np.radians(mk["band_deg"]))
                / np.radians(mk["apo_deg"]), 0.0, 1.0)
    mask = 0.5 - 0.5 * np.cos(np.pi * x)
    phi = pix.phi_of_pixel()
    rng = np.random.default_rng(mk["seed"])
    ct, st = np.cos(theta), np.sin(theta)
    cos_r = np.cos(np.radians(mk["hole_deg"]))
    for _ in range(mk["nholes"]):
        ct0 = rng.uniform(-1.0, 1.0)
        st0 = np.sqrt(1.0 - ct0 * ct0)
        ph0 = rng.uniform(0.0, 2.0 * np.pi)
        mask[ct0 * ct + st0 * st * np.cos(phi - ph0) > cos_r] = 0.0
    return mask


def beam(cfg: dict) -> np.ndarray:
    """Gaussian beam window b_l = exp(-l (l+1) s^2 / 2), s = FWHM /
    sqrt(8 ln 2)."""
    s = np.radians(cfg["fwhm_deg"]) / np.sqrt(8.0 * np.log(2.0))
    ell = np.arange(cfg["lmax"] + 1, dtype=np.float64)
    return np.exp(-0.5 * ell * (ell + 1.0) * s * s)


def fiducial_dl(lmax: int, kind: str, amp: float) -> np.ndarray:
    """bench.py's toy E / B D_ell (example_dl, muK^2): damped acoustic
    structure, any positive spectrum exercising the same paths."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    x = ell / 220.0
    dl = (amp * (1.0 + x) ** -1.2 * (1.0 + 0.6 * np.cos(np.pi * x))
          * np.exp(-((ell / (0.8 * max(lmax, 2))) ** 2)) + 1e-3 * amp)
    if kind == "ee":
        dl = 0.01 * dl * (ell / 100.0) ** 2 / (1.0 + (ell / 100.0) ** 2)
        dl += 1e-5 * amp
    elif kind == "bb":
        dl = 1e-4 * amp * (ell / 80.0) ** 2 / (1.0 + (ell / 80.0) ** 4)
        dl += 1e-6 * amp
    else:
        raise ValueError(f"spectrum kind {kind!r}; ee or bb")
    dl[:2] = 0.0
    return dl


def binned_mean(per_ell: np.ndarray, edges) -> np.ndarray:
    e = np.asarray(edges)
    return np.array([per_ell[lo:hi].mean() for lo, hi in zip(e[:-1], e[1:])])


def cl_factor(lmax: int) -> np.ndarray:
    """C_l / D_l = 2 pi / (l (l+1)), 0 for l < 2."""
    ell = np.arange(lmax + 1, dtype=np.float64)
    out = np.zeros(lmax + 1)
    out[2:] = 2.0 * np.pi / (ell[2:] * (ell[2:] + 1.0))
    return out


def gamma_alpha(edges) -> np.ndarray:
    """Shape of each bin's conjugate gamma variate: sum_l (2l+1)/2 - 1
    over the bin, at least 1."""
    e = np.asarray(edges)
    a = np.array([np.sum(2.0 * np.arange(lo, hi) + 1.0) / 2.0 - 1.0
                  for lo, hi in zip(e[:-1], e[1:])])
    return np.where(a <= 0, 1.0, a)


def _chunks(pix: Pixelization):
    for r0 in range(0, pix.theta.size, _SKY_CHUNK):
        r1 = min(r0 + _SKY_CHUNK, pix.theta.size)
        yield r0, r1


def sky_synth(lmax: int, pix: Pixelization, x: torch.Tensor) -> torch.Tensor:
    """(..., 2, nstate) -> (..., 2, npix) over the whole sphere, float64."""
    out = []
    for r0, r1 in _chunks(pix):
        rs = FullRings(lmax, pix.theta[r0:r1], pix.nphi[r0:r1],
                       pix.phi0[r0:r1], x.device)
        out.append(rs.synth(x))
    return torch.cat(out, dim=-1)


def sky_adjoint(lmax: int, pix: Pixelization, y: torch.Tensor,
                dtype=torch.float64, tf32: bool = False) -> torch.Tensor:
    """The exact transpose of ``sky_synth``: (..., 2, npix) -> (..., 2,
    nstate), in ``dtype`` (with TF32 products for the control)."""
    acc = None
    for r0, r1 in _chunks(pix):
        rs = FullRings(lmax, pix.theta[r0:r1], pix.nphi[r0:r1],
                       pix.phi0[r0:r1], y.device, dtype, tf32)
        p0, p1 = int(pix.start[r0]), int(pix.start[r0] + rs.npix)
        a = rs.adjoint(y[..., p0:p1].to(dtype))
        acc = a if acc is None else acc + a
    return acc


def simulate(cfg: dict, pix: Pixelization, mask: np.ndarray, bl: np.ndarray,
             gen: torch.Generator, device):
    """(the observed (Q, U) maps (2, npix), the sky's (E, B) alm state (2,
    nstate)), float64 on ``device``: the sky drawn from the fiducial
    spectrum, then the noise, both from ``gen``."""
    lmax, L = cfg["lmax"], cfg["lmax"] + 1
    dls = np.stack([fiducial_dl(lmax, k, cfg["amp"]) for k in ("ee", "bb")])
    cl = dls * cl_factor(lmax)[None, :]
    var = (torch.as_tensor(cl, device=device)[:, None, None, :]
           * state_valid(lmax, device)).reshape(2, 2 * L * L)
    xi = torch.randn((2, 2 * L * L), generator=gen, dtype=torch.float64,
                     device=device)
    alm = torch.sqrt(var) * xi
    sky = sky_synth(lmax, pix, alm * torch.as_tensor(bl, device=device)
                    .repeat(2 * L))
    m = torch.as_tensor(mask, device=device)
    tau = m / cfg["sigma2"]
    inv = tau * torch.as_tensor(pix.q[pix.ring_of_pixel()], device=device)
    std = torch.where(inv > 0, 1.0 / torch.sqrt(torch.where(inv > 0, inv,
                                                            1.0)), 0.0)
    n = torch.randn((2, pix.npix), generator=gen, dtype=torch.float64,
                    device=device)
    return (sky + std * n) * m, alm


def start_dl(cfg: dict, alm: torch.Tensor) -> list:
    """The chains' starting binned D_ell per field: the bin means of the
    simulated sky's own D_l = l (l+1) sum_m |a_lm|^2 / (2 pi (2l+1)).  With
    the sky's own state beside it, the start is a draw from the posterior
    the chains sample (the sky was drawn from the model that the sampler
    inverts), so a short burn-in suffices: a start at s = 0 drifts for some
    200 iterations, what the aux + MALA CR step needs to restore the
    data-constrained modes."""
    lmax = cfg["lmax"]
    L = lmax + 1
    ell = np.arange(L, dtype=np.float64)
    sq = (alm.to(torch.float64) ** 2).reshape(2, 2, L, L).sum((1, 2))
    per_l = sq.cpu().numpy() * ell * (ell + 1.0) / (2.0 * np.pi
                                                    * (2.0 * ell + 1.0))
    return [binned_mean(p, b) for p, b in zip(per_l, cfg["bins"])]
