"""Experiment runner: typed configuration, segmented runs, checkpoint and
resume (PyTorch counterpart of ``gibbssampler_tpu.inference.runner``).

- the configuration is one dataclass, ``RunConfig``, with the JAX
  package's fields and defaults; the device is a keyword of
  ``run_experiment``, not a field, so the saved configuration is the same
  JSON in both packages;
- the run is segmented: after every segment a resumable snapshot (the
  chains' generator state, the sampler state, the chains and the
  acceptance histories so far) replaces the previous one, atomically;
- the results are saved as an .npz with the JAX runner's keys: chains,
  acceptance histories, per-segment durations, optional per-phase step
  times, ESS / R-hat / mean summaries and the configuration.

Seeds: ``seed`` seeds the dataset's generator and ``seed + 1`` the chains',
as the JAX runner uses PRNGKey(seed) and PRNGKey(seed + 1); the fenced step
timings draw from a third generator, ``seed + 2``, so the chains do not
depend on ``time_steps``.  The random streams are torch's, not JAX's: the
two packages draw different chains from the same configuration.  A resumed
run continues the uninterrupted run's stream exactly (the generator state
is checkpointed), and on the same device and inputs it reproduces that run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..diagnostics import step_phase_times, summarize_chains
from ..harmonics.spectra import bin_sum, dl_to_cl_factor
from ..ops import with_cut_decomposition
from ..parallel.adapt import (_host, analytic_proposal_sigma,
                              proposal_sigmas_from_results)
from ..schemes import (ASISGibbs, CenteredGibbs, GibbsState,
                       JointCenteredGibbs, JointState, NonCenteredGibbs,
                       PNCPGibbs)
from ..sht import (galactic_band_mask, gauss_legendre_grid, make_healpix_sht,
                   ud_grade)
from .fits_io import read_healpix_map
from .simulate import example_dl, simulate_dataset

__all__ = ["RunConfig", "run_experiment", "save_checkpoint",
           "load_checkpoint"]


@dataclass
class RunConfig:
    """One experiment, as one value (the JAX runner's fields and
    defaults)."""

    lmax: int = 64
    spin: int = 0                        # 0: TT, 2: EE/BB, 3: joint TQU
    grid: str = "gl"                     # gl | healpix
    nside: int = 0                       # healpix nside (default lmax // 2)
    scheme: str = "centered"             # centered | noncentered | asis | pncp
                                         # | joint (spin=3)
    cr_method: str = "exact"             # see schemes.CR_METHODS
    cr_options: dict = field(default_factory=dict)
    r_te: float = 0.0                    # TE correlation of spin-3 data:
                                         # D_TE = r_te sqrt(D_TT D_EE), the
                                         # fields drawn correlated
    noise_sigma2: float = 1.0
    fwhm_deg: float = 0.0
    mask_band_deg: float = 0.0           # analytic galactic cut half-width
    mask_fits: str = ""                  # HEALPix mask FITS file (RING or
                                         # NESTED), ud_graded to the run's
                                         # nside; healpix grid only
    bins: Optional[np.ndarray] = None    # default: unit bins from l=2
    blocks_size: int = 8                 # MH block width in bins
    n_iter_mh: int = 1
    l_cut: int = 0                       # PNCP split
    n_iter: int = 1000
    nchains: int = 4
    segment: int = 500                   # iterations per checkpoint segment
    seed: int = 0
    dtype: str = "float32"
    all_sph: bool = False
    cut: bool = True                     # cut-sky complement decomposition
                                         # on masked grids
    time_steps: bool = False             # fenced per-phase (CR / C_ell) step
                                         # times once per segment
    proposal_from: str = ""              # a previous run's results npz: pool
                                         # its chains into MH proposal scales
    out: str = "run_results.npz"

    def bins_list(self):
        bins = (self.bins if self.bins is not None
                else np.arange(2, self.lmax + 2))
        nf = 2 if self.spin == 2 else 1
        return [np.asarray(bins)] * nf


def _fields(cfg: RunConfig):
    """(nfields, lmax+1) theory D_ell, and the (lmax+1, 3, 3) D_ell blocks
    of correlated spin-3 data (None when r_te is 0)."""
    if cfg.spin == 0:
        fields = example_dl(cfg.lmax, amp=1000.0)[None]
    elif cfg.spin == 3:
        fields = np.stack([example_dl(cfg.lmax, "tt", amp=1000.0),
                           example_dl(cfg.lmax, "ee", amp=1000.0),
                           example_dl(cfg.lmax, "bb", amp=1000.0)])
    else:
        fields = np.stack([example_dl(cfg.lmax, "ee", amp=1000.0),
                           example_dl(cfg.lmax, "bb", amp=1000.0)])
    if cfg.r_te == 0.0:
        return fields, None
    if cfg.spin != 3:
        raise ValueError("r_te requires spin=3 (joint TQU data)")
    blocks = np.zeros((cfg.lmax + 1, 3, 3))
    for f in range(3):
        blocks[:, f, f] = fields[f]
    te = cfg.r_te * np.sqrt(fields[0] * fields[1])
    blocks[:, 0, 1] = blocks[:, 1, 0] = te
    return fields, blocks


def _mask(cfg: RunConfig):
    """The run's mask: (nrings, nphi) on the GL grid, (npix,) RING on
    HEALPix, or None."""
    if cfg.grid == "healpix":
        nside = cfg.nside or max(cfg.lmax // 2, 1)
        if cfg.mask_fits:
            mask_in, _ = read_healpix_map(cfg.mask_fits)
            return ud_grade(mask_in, nside)
        return (galactic_band_mask(nside, cfg.mask_band_deg)
                if cfg.mask_band_deg > 0 else None)
    if cfg.mask_fits:
        raise ValueError("mask_fits requires grid='healpix' (HEALPix pixel "
                         "masks); use mask_band_deg on the GL grid")
    if cfg.mask_band_deg <= 0:
        return None
    grid = gauss_legendre_grid(cfg.lmax)
    lat = np.abs(np.pi / 2 - grid.theta)
    keep = (lat > np.radians(cfg.mask_band_deg)).astype(np.float64)
    return np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))


def _with_cut(cfg: RunConfig, model):
    """The cut decomposition of a masked model, when ``cfg.cut``.  A
    HEALPix mask the decomposition cannot take (masked pixels off the
    belt rings without the sparse split) keeps the full-transform
    model."""
    if not cfg.cut:
        return model
    if cfg.grid == "healpix":
        try:
            return with_cut_decomposition(model)
        except ValueError:
            return model
    return with_cut_decomposition(model)


def _bin_means(values: np.ndarray, bins: np.ndarray, lmax: int) -> np.ndarray:
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    counts = bin_sum(t(np.ones(lmax + 1)), bins, lmax)
    return (bin_sum(t(values), bins, lmax) / counts).numpy()


def _build(cfg: RunConfig, device="cuda"):
    """(scheme, initial spectrum, truth): the simulated dataset on
    ``device``, its cut decomposition, and the configured scheme with its
    bins, 8-bin MH blocks and analytic (or pooled) proposal scales.  For
    ``joint`` the initial spectrum is (C0,), the (lmax+1, 3, 3) C_ell
    blocks with the theory on the diagonal."""
    dtype = getattr(torch, cfg.dtype)
    fields, dl_blocks = _fields(cfg)
    mask = _mask(cfg)
    sht = None
    if cfg.grid == "healpix":
        sht = make_healpix_sht(cfg.nside or max(cfg.lmax // 2, 1), cfg.lmax,
                               dtype=dtype, spin2=(cfg.spin >= 2),
                               device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model, truth = simulate_dataset(
        cfg.lmax, cfg.spin, fields, cfg.noise_sigma2,
        fwhm_radians=np.radians(cfg.fwhm_deg), mask=mask, dtype=dtype,
        device=device, sht=sht, gen=gen, dl_blocks=dl_blocks)
    if mask is not None:
        model = _with_cut(cfg, model)

    bins_list = cfg.bins_list()
    nb = len(bins_list[0]) - 1
    blocks = [(i, min(i + cfg.blocks_size, nb))
              for i in range(0, nb, cfg.blocks_size)]
    dl0 = tuple(_bin_means(f, b, cfg.lmax)
                for f, b in zip(fields, bins_list))
    # the analytic noise-dominated proposal seed, with the observed f_sky
    f_sky = _host(model.noise.f_sky)
    bl = _host(model.bl)
    sig = [analytic_proposal_sigma(bl, cfg.noise_sigma2, model.noise.omega,
                                   cfg.lmax, b,
                                   f_sky=float(f_sky[min(f, len(f_sky) - 1)]))
           for f, b in enumerate(bins_list)]
    if cfg.proposal_from:
        # a preliminary run's chains pooled into the proposal scales, each
        # bin's scaled by 2.38 / sqrt(its block's width)
        sig = proposal_sigmas_from_results(
            cfg.proposal_from, nfields=len(bins_list),
            blocks_list=[blocks] * len(bins_list))
        if len(sig) != len(bins_list) or any(
                len(s) != len(b) - 1 for s, b in zip(sig, bins_list)):
            raise ValueError(
                f"proposal_from={cfg.proposal_from!r} has incompatible "
                f"binning for this config")

    kw = dict(cr_method=cfg.cr_method, cr_options=dict(cfg.cr_options))
    d_alm = None
    if cfg.all_sph:
        if cfg.spin == 0:
            d_alm = model.sht.analysis_state(model.d[0])[None]
        else:
            d_alm = torch.stack(model.sht.analysis_spin2_state(model.d[0],
                                                               model.d[1]))
    blocks_list = [blocks] * len(bins_list)
    if cfg.scheme == "joint":
        if cfg.spin != 3:
            raise ValueError("scheme='joint' requires spin=3 (TQU)")
        scheme = JointCenteredGibbs(
            model, cr_method=("cg" if cfg.cr_method == "cg" else "exact"),
            cr_options=dict(cfg.cr_options))
        fac = dl_to_cl_factor(cfg.lmax, torch.float64).numpy()
        C0 = np.zeros((cfg.lmax + 1, 3, 3))
        for f in range(3):
            C0[:, f, f] = fields[f] * fac
        return scheme, (C0,), truth
    if cfg.scheme == "centered":
        scheme = CenteredGibbs(model, bins_list, **kw)
    elif cfg.scheme == "noncentered":
        scheme = NonCenteredGibbs(model, bins_list, blocks_list, sig,
                                  n_iter_mh=cfg.n_iter_mh,
                                  all_sph=cfg.all_sph, d_alm=d_alm, **kw)
    elif cfg.scheme == "asis":
        scheme = ASISGibbs(model, bins_list, blocks_list, sig,
                           n_iter_mh=cfg.n_iter_mh, all_sph=cfg.all_sph,
                           d_alm=d_alm, **kw)
    elif cfg.scheme == "pncp":
        scheme = PNCPGibbs(model, bins_list, blocks_list, sig,
                           l_cut=cfg.l_cut, n_iter_mh=cfg.n_iter_mh, **kw)
    else:
        raise ValueError(f"unknown scheme {cfg.scheme!r}")
    return scheme, dl0, truth


def save_checkpoint(path, gen_state, state, chains, iters_done,
                    histories=None):
    """Resumable snapshot, written to a temporary file and then renamed
    over ``path``: the chains' generator state (``torch.Generator.
    get_state()``, stored as ``key``), the sampler state (a GibbsState as
    ``state_s`` and ``state_dl_<f>``, a JointState as ``state_s`` and
    ``state_cl``), the chains so far (``chain_<f>``) and ``histories``,
    the results' other per-segment arrays so far under their result keys
    (``hist_<key>``)."""
    flat = {"iters_done": iters_done,
            "key": np.asarray(gen_state.cpu().numpy(), dtype=np.uint8)}
    for f, c in enumerate(chains):
        flat[f"chain_{f}"] = np.asarray(c)
    flat["state_s"] = _host(state.s)
    if isinstance(state, JointState):
        flat["state_cl"] = _host(state.cl)
    else:
        for f, d in enumerate(state.dl):
            flat[f"state_dl_{f}"] = _host(d)
    for k, v in (histories or {}).items():
        flat[f"hist_{k}"] = np.asarray(v)
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, str(path))


def load_checkpoint(path, device="cuda"):
    """The snapshot of ``save_checkpoint`` with its state on ``device``, or
    None when there is none: {"iters_done", "key" (the generator state),
    "state", "chains", "histories"}."""
    if not os.path.exists(str(path)):
        return None
    with np.load(str(path)) as z:
        t = lambda a: torch.as_tensor(a, device=device)
        if "state_cl" in z.files:
            state = JointState(s=t(z["state_s"]), cl=t(z["state_cl"]))
            nf = len([k for k in z.files if k.startswith("chain_")])
        else:
            nf = len([k for k in z.files if k.startswith("state_dl_")])
            state = GibbsState(s=t(z["state_s"]),
                               dl=tuple(t(z[f"state_dl_{f}"])
                                        for f in range(nf)))
        return dict(iters_done=int(z["iters_done"]),
                    key=torch.as_tensor(z["key"], dtype=torch.uint8),
                    state=state, chains=[z[f"chain_{f}"] for f in range(nf)],
                    histories={k[5:]: z[k] for k in z.files
                               if k.startswith("hist_")})


def _joint_summary_chain(chain, lmin: int):
    """(nchains, n_iter, L, k, k) joint block chain -> (nchains, n_iter,
    nscalar) over the unique (l >= lmin, upper-triangle) entries: the
    scalar series the ESS / R-hat diagnostics run on."""
    c = np.asarray(chain, dtype=np.float64)
    k = c.shape[-1]
    iu, ju = np.triu_indices(k)
    flat = c[..., iu, ju][:, :, lmin:, :]
    return flat.reshape(c.shape[0], c.shape[1], -1)


def _append(hist: dict, key: str, value, axis=None):
    """Extend the history ``hist[key]`` by one segment: along ``axis`` (the
    iterations) or as one more entry."""
    value = np.asarray(value)
    if axis is None:
        value = value[None]
        axis = 0
    hist[key] = (value if key not in hist
                 else np.concatenate([hist[key], value], axis=axis))


def run_experiment(cfg: RunConfig, resume: bool = True, verbose=print,
                   device="cuda"):
    """Segmented run with checkpoint and resume on ``device``; returns the
    results dict and writes it to ``cfg.out``.  Every scheme, ``joint``
    included, goes through the same loop.  ``verbose`` receives one line
    per segment, after the segment's checkpoint is written, and one on
    resume."""
    scheme, dl0, truth = _build(cfg, device)
    joint = cfg.scheme == "joint"
    ckpt_path = cfg.out + ".ckpt.npz"
    ck = load_checkpoint(ckpt_path, device) if resume else None
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    if ck is None:
        iters_done, chains, hist = 0, None, {}
        if joint:
            scheme.check_cl_init(dl0[0])
            states = scheme.init_state(dl0[0], cfg.nchains, gen)
        else:
            states = scheme.init_state(dl0, cfg.nchains, gen)
    else:
        iters_done, chains = ck["iters_done"], ck["chains"]
        states, hist = ck["state"], ck["histories"]
        gen.set_state(ck["key"])
        verbose(f"resumed at iteration {iters_done}")
    probe_gen = (torch.Generator(device=device).manual_seed(cfg.seed + 2)
                 if cfg.time_steps else None)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if torch.device(device).type == "cuda" else (lambda: None)

    while iters_done < cfg.n_iter:
        seg = min(cfg.segment, cfg.n_iter - iters_done)
        sync()
        t0 = time.time()
        out = scheme.run(None, n_iter=seg, nchains=cfg.nchains, gen=gen,
                         state=states)
        sync()
        dt = time.time() - t0
        states = out["final_state"]
        _append(hist, "durations", dt)
        seg_chains = [_host(c) for c in out["dl_chains"]]
        cr = _host(out["cr_accept"])                 # (nchains, seg)
        _append(hist, "cr_accepts", cr.mean())
        _append(hist, "cr_accept_chain", cr, axis=1)
        for f, m in enumerate(out.get("mh_accept", ())):
            _append(hist, f"mh_accept_{f}", _host(m), axis=1)
        chains = (seg_chains if chains is None else
                  [np.concatenate([c, s], axis=1)
                   for c, s in zip(chains, seg_chains)])
        iters_done += seg
        if cfg.time_steps:
            pt = step_phase_times(scheme, states, probe_gen)
            for name in ("cr", "cls", "full"):
                _append(hist, f"step_time_{name}", pt[name])
        save_checkpoint(ckpt_path, gen.get_state(), states, chains,
                        iters_done, hist)
        verbose(f"segment done: {iters_done}/{cfg.n_iter} iters "
                f"({dt:.1f}s, {dt / seg * 1e3:.0f} ms/iter)")

    summaries = [summarize_chains(_joint_summary_chain(c, scheme.lmin)
                                  if joint else c) for c in chains]
    results = {
        "config": json.dumps({k: (v.tolist() if isinstance(v, np.ndarray)
                                  else v)
                              for k, v in dataclasses.asdict(cfg).items()}),
        **hist,
    }
    for f, c in enumerate(chains):
        results[f"dl_chain_{f}"] = c
        results[f"ess_{f}"] = summaries[f]["ess"]
        results[f"rhat_{f}"] = summaries[f]["rhat"]
        results[f"mean_{f}"] = summaries[f]["mean"]
    np.savez(cfg.out, **results)
    try:
        os.remove(ckpt_path)
    except OSError:
        pass
    return results
