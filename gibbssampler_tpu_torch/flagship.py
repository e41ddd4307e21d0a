"""bench.py's flagship configurations on the port: the counterpart of
``bench.py``'s ``build()`` (bench.py:141-355) with BENCH_SCHEME=asis and
BENCH_SCHEME=pncp.

A polarized E/B sky (``example_dl``, amp 1000) at lmax 512, noise
variance 0.2^2 per pixel, a 0.5 deg beam, float32, simulated from a seed
and cut-decomposed, on one of

    grid  "gl"       Gauss-Legendre 513 x 1026
          "healpix"  HEALPix nside lmax / 2, padded layout
    mask  "band"     the ~80% f_sky galactic cut (|lat| > 0.2 rad on GL,
                     11.5 deg on HEALPix)
          "planckish" an apodized +-11.5 deg band plus 200 point-source
                     holes (bench.py:160-213)

with bench.py's transform options (``build``'s ``table_dtype``,
``fft_mode``, ``ring_split``: BENCH_TABLE_DTYPE, BENCH_FFT_MODE,
BENCH_RING_SPLIT; "fft_mode" on GL only, as in bench.py) and, with
``cut=False`` (BENCH_CUT=0), without the cut decomposition: the
likelihood then runs through the full grid's transforms,
sampled by ``ASISGibbs`` with bench.py's bins and blocks (EE unit bins in
one block; BB unit bins to l = 396 then 16 wide bins, a 277-bin block and
133 single-bin blocks), or by ``PNCPGibbs`` on the same bins with a
per-field l_cut (bench.py's BENCH_LCUT, default "none,300": EE fully
centered with no block, BB single-bin blocks from l = 300), and one of
bench.py's two CR methods (``CR_OPTIONS``).
The proposal scales come from the port's tuned records
(``tuned_proposals.json`` beside this file, written by
``python -m gibbssampler_tpu_torch.tune``), keyed by scheme, grid, mask,
lmax, bin counts, CR method and (PNCP) l_cut; a missing record raises
``LookupError``.  ``seed=True`` takes bench.py's analytic seeds instead
(bench.py:273-276, divided by sqrt(block width) for PNCP, bench.py:337-
345), which is where the tuner starts.  Below lmax 396 the bins follow
bench.py's smoke-test rule (unit BB bins, a big block of 2/3 of them).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .inference import example_dl, simulate_dataset
from .interop import port_tuned_proposal_sigmas
from .ops import with_cut_decomposition
from .parallel.adapt import analytic_proposal_sigma, block_widths
from .schemes import ASISGibbs, CenteredGibbs, PNCPGibbs
from .sht import galactic_band_mask, make_healpix_sht, make_sht, pix2ang_ring

__all__ = ["RECORDS", "GRIDS", "MASKS", "CR_OPTIONS", "planckish_mask",
           "healpix_planckish_mask", "planck_bins", "binned_mean",
           "flagship_sht", "flagship_mask", "dataset", "asis_bins_blocks",
           "analytic_sigmas", "asis_setup", "PNCP_LCUT", "pncp_bins_blocks",
           "pncp_setup", "start_state", "build"]

RECORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tuned_proposals.json")
GRIDS = ("gl", "healpix")
MASKS = ("band", "planckish")
# bench.py's options of the two CR methods it runs inside ASIS
CR_OPTIONS = {"aux_mala": {"n_gibbs": 1, "tau": 0.02},
              "overrelax": {"alpha": -0.995, "n_gibbs": 1}}
NOISE_SIGMA2 = 0.2 ** 2
FWHM_DEG = 0.5
# bench.py's BB binning: unit bins up to l = 396, then these edges
BB_UNIT_TO = 396
BB_WIDE = [396, 398, 400, 402, 406, 410, 415, 420, 425, 430, 435, 440, 445,
           460, 475, 495]
BB_BIG = 277
# bench.py's default BENCH_LCUT: EE fully centered, BB non-centered from 300
PNCP_LCUT = ("none", 300)


def planckish_mask(grid, nholes=200, seed=5):
    """bench.py's planckish GL mask (bench.py:190-211): an apodized
    +-11.5 deg band with a 3 deg cosine ramp, plus ``nholes`` holes of
    0.35 deg radius at random positions over the sphere."""
    lat = np.abs(np.pi / 2 - grid.theta)
    b0, apo = np.radians(11.5), np.radians(3.0)
    x = np.clip((lat - b0) / apo, 0.0, 1.0)
    keep = 0.5 - 0.5 * np.cos(np.pi * x)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi)).copy()
    rng = np.random.default_rng(seed)
    rhole = np.radians(0.35)
    phi = 2.0 * np.pi * np.arange(grid.nphi) / grid.nphi
    ct, st = np.cos(grid.theta), np.sin(grid.theta)
    for _ in range(nholes):
        ct0 = rng.uniform(-1.0, 1.0)
        st0 = np.sqrt(1.0 - ct0 * ct0)
        ph0 = rng.uniform(0.0, 2.0 * np.pi)
        cosd = (ct0 * ct[:, None]
                + st0 * st[:, None] * np.cos(phi[None, :] - ph0))
        mask[cosd > np.cos(rhole)] = 0.0
    return mask


def healpix_planckish_mask(nside, nholes=200, seed=5):
    """bench.py's planckish HEALPix mask (bench.py:160-178) in RING order:
    the same band, ramp and holes as ``planckish_mask`` at the HEALPix
    pixel centres."""
    theta, phi = pix2ang_ring(nside, np.arange(12 * nside * nside))
    lat = np.abs(np.pi / 2 - theta)
    b0, apo = np.radians(11.5), np.radians(3.0)
    x = np.clip((lat - b0) / apo, 0.0, 1.0)
    mask = 0.5 - 0.5 * np.cos(np.pi * x)
    rng = np.random.default_rng(seed)
    rhole = np.radians(0.35)
    ct, st = np.cos(theta), np.sin(theta)
    for _ in range(nholes):
        ct0 = rng.uniform(-1.0, 1.0)
        st0 = np.sqrt(1.0 - ct0 * ct0)
        ph0 = rng.uniform(0.0, 2.0 * np.pi)
        mask[ct0 * ct + st0 * st * np.cos(phi - ph0) > np.cos(rhole)] = 0.0
    return mask


def planck_bins(lmax):
    """Unit bins to l = 50, then 10 wide to 200 and 30 wide beyond."""
    edges = list(range(2, min(51, lmax + 2)))
    l = edges[-1]
    while l < lmax + 1:
        l = min(l + (10 if l < 200 else 30), lmax + 1)
        edges.append(l)
    return np.array(edges)


def binned_mean(per_ell, bins):
    """Binned mean of a per-ell array (the starting D_ell)."""
    return np.array([per_ell[lo:hi].mean() for lo, hi in zip(bins[:-1],
                                                             bins[1:])])


def flagship_sht(grid: str, lmax: int = 512, device="cuda",
                 dtype=torch.float32, table_dtype=None,
                 fft_mode: str = "matmul", ring_split: bool = False):
    """The full grid's spin-2 transform: GL, or HEALPix nside lmax / 2 in
    the padded layout (which takes no ``fft_mode``)."""
    if grid == "healpix":
        return make_healpix_sht(lmax // 2, lmax, dtype=dtype, spin2=True,
                                layout="padded", device=device,
                                table_dtype=table_dtype,
                                ring_split=ring_split)
    if grid == "gl":
        return make_sht(lmax, dtype=dtype, spin2=True, device=device,
                        fft_mode=fft_mode, table_dtype=table_dtype,
                        ring_split=ring_split)
    raise ValueError(f"grid={grid!r}; one of {GRIDS}")


def flagship_mask(grid: str, mask: str, sht) -> np.ndarray:
    """bench.py's mask: (nrings, nphi) on GL, (npix,) in RING order on
    HEALPix."""
    if mask not in MASKS:
        raise ValueError(f"mask={mask!r}; one of {MASKS}")
    if grid == "healpix":
        if mask == "planckish":
            return healpix_planckish_mask(sht.nside)
        return galactic_band_mask(sht.nside, 11.5)
    if mask == "planckish":
        return planckish_mask(sht.grid)
    keep = (np.abs(np.pi / 2 - sht.grid.theta) > 0.2).astype(np.float64)
    return np.broadcast_to(keep[:, None], (sht.nrings, sht.nphi))


def dataset(grid: str, mask: str, lmax: int = 512, device="cuda",
            dtype=torch.float32, sht=None, seed: int = 0, cut: bool = True):
    """The flagship dataset, cut-decomposed unless ``cut`` is False:
    (model, per-ell D_ell (2, lmax + 1) of the sky, the mask).  ``sht``:
    the full grid's transform when already built (``flagship_sht``)."""
    if sht is None:
        sht = flagship_sht(grid, lmax, device, dtype)
    m = flagship_mask(grid, mask, sht)
    gen = torch.Generator(device=sht.device).manual_seed(seed)
    dls = np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")])
    model, _ = simulate_dataset(lmax, 2, dls, NOISE_SIGMA2,
                                fwhm_radians=np.radians(FWHM_DEG), mask=m,
                                dtype=dtype, sht=sht, gen=gen)
    return (with_cut_decomposition(model) if cut else model), dls, m


def asis_bins_blocks(lmax: int):
    """bench.py's ASIS bins and blocks (bench.py:258-272): ([bins_ee,
    bins_bb], [blocks_ee, blocks_bb])."""
    bins_ee = np.arange(2, lmax + 2)
    if lmax >= BB_UNIT_TO:
        bins_bb = np.array(list(range(2, BB_UNIT_TO)) + BB_WIDE + [lmax + 1])
    else:
        bins_bb = np.arange(2, lmax + 2)
    nb_ee, nb_bb = len(bins_ee) - 1, len(bins_bb) - 1
    big = BB_BIG if nb_bb > BB_BIG else max(1, (2 * nb_bb) // 3)
    blocks = [[(0, nb_ee)],
              [(0, big)] + [(i, i + 1) for i in range(big, nb_bb)]]
    return [bins_ee, bins_bb], blocks


def analytic_sigmas(model, bins_list):
    """bench.py's analytic proposal seeds (bench.py:273-276): each field's
    f_sky, not rescaled for the joint blocks."""
    f_sky = model.noise.f_sky.cpu().numpy()
    return [analytic_proposal_sigma(model.bl.cpu().numpy(), NOISE_SIGMA2,
                                    model.noise.omega, model.lmax, b,
                                    f_sky=float(f_sky[f]))
            for f, b in enumerate(bins_list)]


def asis_setup(model, dls, grid: str, mask: str, cr: str = "aux_mala",
               seed: bool = False, records=RECORDS, mh_fast: str = "auto"):
    """The flagship ASISGibbs scheme on ``model`` and its D_ell start (the
    sky's binned means): the port's tuned record for (grid, mask, cr), or
    with ``seed`` the analytic seeds.  ``mh_fast``: the scheme's MH engine
    choice ("phi" pins the phi-domain engine: the same Markov kernel, so
    the same record)."""
    if cr not in CR_OPTIONS:
        raise ValueError(f"cr={cr!r}; one of {tuple(CR_OPTIONS)}")
    lmax = model.lmax
    bins, blocks = asis_bins_blocks(lmax)
    if seed:
        sig = analytic_sigmas(model, bins)
    else:
        sig = port_tuned_proposal_sigmas(records, "asis", grid, mask, lmax,
                                         [len(b) - 1 for b in bins], cr)
    scheme = ASISGibbs(model, bins, blocks, sig, n_iter_mh=1, cr_method=cr,
                       cr_options=CR_OPTIONS[cr], mh_fast=mh_fast)
    dl0 = tuple(binned_mean(d, b) for d, b in zip(dls, bins))
    return scheme, dl0


def pncp_bins_blocks(lmax: int, lcut=PNCP_LCUT):
    """bench.py's PNCP configuration (bench.py:324-336): the ASIS bins, the
    per-field l_cut ("none" is the field's last bin edge: fully centered)
    and the blocks above it, one joint EE block (none when EE is fully
    centered) and BB single-bin blocks.  Returns (bins, l_cut, blocks);
    ValueError when an l_cut is not a bin boundary."""
    bins, _ = asis_bins_blocks(lmax)
    lc = [int(b[-1]) if c == "none" else int(c) for c, b in zip(lcut, bins)]
    cbs = [int(np.searchsorted(b, c)) for b, c in zip(bins, lc)]
    if any(cb >= len(b) or b[cb] != c for b, c, cb in zip(bins, lc, cbs)):
        raise ValueError(f"lcut={lcut}: {lc} must be bin boundaries")
    nb_ee, nb_bb = len(bins[0]) - 1, len(bins[1]) - 1
    blocks = [[] if cbs[0] >= nb_ee else [(cbs[0], nb_ee)],
              [(i, i + 1) for i in range(cbs[1], nb_bb)]]
    return bins, lc, blocks


def pncp_setup(model, dls, grid: str, mask: str, cr: str = "aux_mala",
               seed: bool = False, records=RECORDS, lcut=PNCP_LCUT):
    """bench.py's PNCPGibbs scheme on ``model`` and its D_ell start: the
    port's tuned record for (grid, mask, cr, l_cut), or with ``seed`` the
    analytic seeds divided by sqrt(block width)."""
    if cr not in CR_OPTIONS:
        raise ValueError(f"cr={cr!r}; one of {tuple(CR_OPTIONS)}")
    lmax = model.lmax
    bins, lc, blocks = pncp_bins_blocks(lmax, lcut)
    if seed:
        sig = [s / np.sqrt(block_widths(bl, len(s)))
               for s, bl in zip(analytic_sigmas(model, bins), blocks)]
    else:
        sig = port_tuned_proposal_sigmas(records, "pncp", grid, mask, lmax,
                                         [len(b) - 1 for b in bins], cr,
                                         l_cut=lc)
    scheme = PNCPGibbs(model, bins, blocks, sig, l_cut=lc, n_iter_mh=1,
                       cr_method=cr, cr_options=CR_OPTIONS[cr])
    dl0 = tuple(binned_mean(d, b) for d, b in zip(dls, bins))
    return scheme, dl0


def start_state(scheme, dl0, nchains: int, gen=None):
    """The chains' start at ``dl0``: the scheme's initial CR draw, but for
    the overrelaxed CR the aux_mala draw (bench.py's default CR).  From
    s = 0 an overrelaxed sweep gives s ~ (1 - alpha) m with a tenth of the
    posterior's spread, so the inverse-gamma draw that follows shrinks the
    noise-dominated bins' D_ell a hundredfold, and the slowly mixing chains
    carry that start for hundreds of iterations."""
    if scheme.cr_method == "overrelax":
        scheme = CenteredGibbs(scheme.model, scheme.bins_list,
                               cr_method="aux_mala",
                               cr_options=CR_OPTIONS["aux_mala"])
    return scheme.init_state(dl0, nchains, gen)


def build(grid: str, mask: str, cr: str = "aux_mala", device="cuda",
          lmax: int = 512, seed: bool = False, records=RECORDS,
          dtype=torch.float32, scheme: str = "asis", lcut=PNCP_LCUT,
          table_dtype=None, fft_mode: str = "matmul",
          ring_split: bool = False, cut: bool = True):
    """bench.py's ``scheme`` ("asis" or "pncp", with its per-field
    ``lcut``) for (grid, mask, cr) on its dataset, and its D_ell start:
    (scheme, dl0).  ``table_dtype``, ``fft_mode`` and ``ring_split`` build
    the full transform (``flagship_sht``), ``cut`` the cut decomposition;
    the tuned record is the same: the options change how the posterior is
    computed, not the posterior."""
    if scheme not in ("asis", "pncp"):
        raise ValueError(f"scheme={scheme!r}; one of asis, pncp")
    sht = flagship_sht(grid, lmax, device, dtype, table_dtype, fft_mode,
                       ring_split)
    model, dls, _ = dataset(grid, mask, lmax, device, dtype, sht=sht,
                            cut=cut)
    if scheme == "pncp":
        return pncp_setup(model, dls, grid, mask, cr, seed, records, lcut)
    return asis_setup(model, dls, grid, mask, cr, seed, records)
