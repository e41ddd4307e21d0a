"""Card-only cases of the port's schemes (marker ``cuda``; they skip where
there is no NVIDIA GPU).  No jax here, so they also run where jax is not
installed: ``python -m pytest --noconftest -q tests/test_torch_card.py``.

One CenteredGibbs iteration with the CG CR and one PNCPGibbs iteration on
the table engine (identity re-centering below l_cut), band mask, lmax 12,
float64, card against CPU on the same injected variates, with the CG
iterations per chain equal.  One ASIS iteration at lmax 12 in float64, on the card and on the CPU from
the same dataset and injected variates, on a band mask, on a holey mask
(the floor + sparse-hole split) and on a holey HEALPix mask at nside 6 in
the padded layout (belt-row floor at nphi = 2 lmax with phased rows,
cap-ring holes in the point set): the Legendre kernels inside the CR step
and the MH step's syntheses, the point-set transform and the table
engine's contractions (with its ring-phase and Nyquist paths on HEALPix)
on the card, against the CPU's plain versions.  The runner at lmax 32 on
the card: a run crashed after its first segment and resumed equals the
uninterrupted run bit for bit.  One JointCenteredGibbs step (the exact
joint CR and the inverse-Wishart draw) at lmax 12 in float64, card
against CPU on the same injected variates.  One nc_cls_sample_cut sweep
on the phi-domain and on the coefficient m-domain engine at lmax 16 in
float64, card against CPU on the same uniforms."""

import numpy as np
import pytest
import torch

from torch_parity import (cuda_device, holey_healpix_mask,  # noqa: F401
                          holey_mask, n)
from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
from gibbssampler_tpu_torch.interop import model_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.samplers import cr as cr_mod
from gibbssampler_tpu_torch.schemes import (ASISGibbs, CenteredGibbs,
                                            PNCPGibbs)
from gibbssampler_tpu_torch.schemes.gibbs import GibbsState
from gibbssampler_tpu_torch.sht import gauss_legendre_grid, make_healpix_sht
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

LMAX = 12
NCH = 4
BINS = [np.arange(2, LMAX + 2), np.array([2, 3, 4, 5, 6, 7, 8, 10, 11, 13])]
BLOCKS = [[(0, 11)], [(0, 3)] + [(i, i + 1) for i in range(3, 9)]]
OPTS = {"n_gibbs": 1, "tau": 0.02}


def _arrays(kind):
    """The band-, holey- or HEALPix-holey-masked polarized dataset as
    ``model_from_numpy`` takes it."""
    gen = torch.Generator().manual_seed(0)
    sht = None
    if kind == "healpix":
        sht = make_healpix_sht(LMAX // 2, LMAX, dtype=torch.float64,
                               spin2=True, layout="padded", device="cpu")
        mask = holey_healpix_mask(LMAX // 2)
    else:
        grid = gauss_legendre_grid(LMAX)
        if kind == "band":
            keep = (np.abs(np.pi / 2 - grid.theta) > 0.2).astype(np.float64)
            mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
        else:
            mask = holey_mask(grid, nholes=4)
    dls = np.stack([example_dl(LMAX, "ee"), example_dl(LMAX, "bb")])
    m, _ = simulate_dataset(LMAX, 2, dls, 0.2 ** 2,
                            fwhm_radians=np.radians(0.5), mask=mask,
                            dtype=torch.float64, device="cpu", sht=sht,
                            gen=gen)
    arrays = {"d": n(m.d), "tau": n(m.noise.tau), "q_map": n(m.noise.q_map),
              "omega": m.noise.omega, "bl": n(m.bl), "spin": 2}
    if kind == "healpix":
        arrays.update(grid="healpix", nside=LMAX // 2, layout="padded")
    else:
        g = m.sht.grid
        arrays.update(theta=g.theta, weights=g.weights, phi0=g.phi0,
                      nphi=g.nphi)
    return arrays, dls


# launches per ASIS iteration: the CR step's 3 cut syntheses and 3 cut
# adjoints and the MH step's 3 syntheses (u0 and two big blocks), two tables
# each, and twice that with the point set beside the floor rings
LAUNCHES = {"band": (12, 6), "holey": (24, 12), "healpix": (24, 12)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(LAUNCHES))
def test_asis_step_card_matches_cpu(cuda_device, kind):
    arrays, dls = _arrays(kind)
    dl0 = [np.tile([d[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])],
                   (NCH, 1)) for d, b in zip(dls, BINS)]
    rng = np.random.default_rng(1)
    inj = None
    outs = []
    for device in ("cpu", cuda_device):
        model = with_cut_decomposition(model_from_numpy(arrays, device))
        assert model.has_sparse == (kind != "band")
        scheme = ASISGibbs(model, BINS, BLOCKS, [0.3 * d[0] for d in dl0],
                           cr_method="aux_mala", cr_options=OPTS)
        assert scheme._use_cut_mh
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        if inj is None:
            var = n(scheme.var_cls(tuple(t(d) for d in dl0)))
            s0 = np.sqrt(var) * rng.normal(size=var.shape)
            ntot = sum(len(b) - 1 for b in BINS)
            pool = {"state": rng.normal(size=(NCH, 2, 2, model.nstate)),
                    "aux": rng.normal(size=(NCH, 1)
                                      + tuple(model.w_cut.shape))}
            if model.has_sparse:
                pool["sp"] = rng.normal(size=(NCH, 1)
                                        + tuple(model.w_sp.shape))
            inj = {"noise": pool,
                   "u": rng.uniform(size=NCH),
                   "gammas": [rng.gamma(3.0, size=(NCH, len(b) - 1))
                              for b in BINS],
                   "u_prop": rng.uniform(size=(NCH, 1, ntot)),
                   "u_acc": rng.uniform(size=(NCH, 1, sum(map(len,
                                                              BLOCKS))))}
        kw = {k: ({kk: t(vv) for kk, vv in v.items()} if k == "noise"
                  else tuple(t(x) for x in v) if k == "gammas" else t(v))
              for k, v in inj.items()}
        lk.reset_launch_counts()
        new, info = scheme.step(GibbsState(s=t(s0),
                                           dl=tuple(t(d) for d in dl0)),
                                **kw)
        launches = (lk.legendre_synth_tri.launches,
                    lk.legendre_adj_tri.launches)
        outs.append([n(x) for x in (new.s, *new.dl, info["cr_accept"],
                                    *info["mh_accept"])])
    assert launches == LAUNCHES[kind]
    for a, b in zip(outs[0][:4], outs[1][:4]):
        np.testing.assert_allclose(b, a, rtol=1e-9,
                                   atol=1e-9 * np.abs(a).max())
    for a, b in zip(outs[0][4:], outs[1][4:]):
        np.testing.assert_array_equal(b, a)


# PNCP: EE non-centered from l = 4 in one block, BB single-bin blocks from
# l = 6; per iteration the CR step's 3 + 3 cut transforms and the MH step's
# 2 syntheses (u0 and the EE block's move), two tables each
PNCP_LCUT = (4, 6)
PNCP_BLOCKS = [[(2, 11)], [(i, i + 1) for i in range(4, 9)]]
PNCP_LAUNCHES = (10, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["cg", "pncp"])
def test_cg_and_pncp_steps_card_match_cpu(cuda_device, scheme):
    """One CenteredGibbs step with cr_method "cg" (and its cg_cr draw alone:
    per-chain iterations equal; launches, a full-grid adjoint of two
    tables and one cut synthesis and adjoint per iteration), or one
    PNCPGibbs step on the table engine, card against CPU."""
    arrays, dls = _arrays("band")
    cbins = [np.array([2, 4, 7, 10, 13])] * 2
    bins = cbins if scheme == "cg" else BINS
    dl0 = [np.tile([d[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])],
                   (NCH, 1)) for d, b in zip(dls, bins)]
    rng = np.random.default_rng(2)
    inj, outs, iters = None, [], []
    for device in ("cpu", cuda_device):
        model = with_cut_decomposition(model_from_numpy(arrays, device))
        if scheme == "cg":
            sch = CenteredGibbs(model, bins, cr_method="cg")
        else:
            sch = PNCPGibbs(model, bins, PNCP_BLOCKS,
                            [0.3 * d[0] for d in dl0], l_cut=PNCP_LCUT,
                            cr_method="aux_mala", cr_options=OPTS)
            assert sch._use_cut_mh and sch.mh_plan.lowm is not None
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        if inj is None:
            var = n(sch.var_cls(tuple(t(d) for d in dl0)))
            s0 = np.sqrt(var) * rng.normal(size=var.shape)
            pool = {"state": rng.normal(size=(NCH, 2, 2, model.nstate))}
            if scheme == "cg":
                pool["pix"] = rng.normal(size=(NCH, 1)
                                         + tuple(model.noise.tau.shape))
            else:
                pool["aux"] = rng.normal(size=(NCH, 1)
                                         + tuple(model.w_cut.shape))
            inj = {"noise": pool, "u": rng.uniform(size=NCH),
                   "gammas": [rng.gamma(3.0, size=(NCH, len(b) - 1))
                              for b in bins]}
            if scheme == "pncp":
                inj["u_prop"] = rng.uniform(size=(NCH, 1, sum(
                    len(b) - 1 for b in bins)))
                inj["u_acc"] = rng.uniform(size=(NCH, 1, sum(
                    map(len, sch.blocks_list))))
        kw = {k: ({kk: t(vv) for kk, vv in v.items()} if k == "noise"
                  else tuple(t(x) for x in v) if k == "gammas" else t(v))
              for k, v in inj.items()}
        state = GibbsState(s=t(s0), dl=tuple(t(d) for d in dl0))
        if scheme == "cg":
            var_t = sch.var_cls(state.dl)
            lk.reset_launch_counts()
            x, info = cr_mod.cg_cr(model, var_t, sch.bt_ninv_d,
                                   noise={"state": kw["noise"]["state"][:, :1],
                                          "pix": kw["noise"]["pix"]})
            its = n(info.extra)
            iters.append(its)
            launches = (lk.legendre_synth_tri.launches,
                        lk.legendre_adj_tri.launches)
            want = (2 * int(its.max()), 2 + 2 * int(its.max()))
        else:
            want = PNCP_LAUNCHES
        if scheme == "pncp":
            lk.reset_launch_counts()
        new, info = sch.step(state, **kw)
        if scheme == "pncp":
            launches = (lk.legendre_synth_tri.launches,
                        lk.legendre_adj_tri.launches)
        outs.append([n(a) for a in (new.s, *new.dl, info["cr_accept"],
                                    *info.get("mh_accept", ()))])
    assert launches == want
    if scheme == "cg":
        np.testing.assert_array_equal(iters[1], iters[0])
        assert (iters[0] > 0).all()
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_allclose(b, a, rtol=1e-9,
                                   atol=1e-9 * np.abs(a).max())
    for a, b in zip(outs[0][3:], outs[1][3:]):
        np.testing.assert_array_equal(b, a)


class _Crash(Exception):
    pass


def _crash_after_first_segment(msg):
    if str(msg).startswith("segment done"):
        raise _Crash(msg)


@pytest.mark.cuda
def test_runner_crash_resume_card_bit_exact(cuda_device, tmp_path):
    """The runner's README configuration cut to lmax 32 and 4 chains
    (band mask, cut decomposition, aux_gibbs CR, direct MH on 8-bin
    blocks, float32): crashed by its verbose callback after the first
    segment's checkpoint, then resumed, it writes the uninterrupted run's
    chains and acceptance histories bit for bit."""
    from gibbssampler_tpu_torch.inference import RunConfig, run_experiment
    kw = dict(lmax=32, spin=2, grid="gl", scheme="asis",
              cr_method="aux_gibbs", cr_options={"n_gibbs": 4},
              noise_sigma2=0.04, fwhm_deg=0.5, mask_band_deg=10.0,
              nchains=4, dtype="float32", n_iter=6, segment=3,
              time_steps=True)
    ref = run_experiment(RunConfig(**kw, out=str(tmp_path / "ref.npz")),
                         verbose=lambda *a: None, device=cuda_device)
    cfg = RunConfig(**kw, out=str(tmp_path / "crash.npz"))
    with pytest.raises(_Crash):
        run_experiment(cfg, verbose=_crash_after_first_segment,
                       device=cuda_device)
    res = run_experiment(cfg, verbose=lambda *a: None, device=cuda_device)
    timed = {"config", "durations", "step_time_cr", "step_time_cls",
             "step_time_full"}
    assert sorted(res) == sorted(ref)
    for k in sorted(set(ref) - timed):
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    assert np.isfinite(res["dl_chain_0"]).all()


@pytest.mark.cuda
def test_joint_step_card_matches_cpu(cuda_device):
    """One JointCenteredGibbs step of 3 chains at lmax 12 in float64 with
    TE-correlated data: the data term through the float64 kernels, the
    exact joint CR's per-ell factorizations and the inverse-Wishart draw
    on the card, against the CPU on the same injected variates (<= 1e-9
    relative)."""
    from gibbssampler_tpu_torch.samplers import synfast_joint
    from gibbssampler_tpu_torch.schemes import JointCenteredGibbs
    from gibbssampler_tpu_torch.interop import state_from_numpy
    gen = torch.Generator().manual_seed(0)
    fields = np.stack([example_dl(LMAX, k) for k in ("tt", "ee", "bb")])
    blocks = np.zeros((LMAX + 1, 3, 3))
    for f in range(3):
        blocks[:, f, f] = fields[f]
    blocks[:, 0, 1] = blocks[:, 1, 0] = 0.5 * np.sqrt(fields[0] * fields[1])
    m, _ = simulate_dataset(LMAX, 3, fields, 0.2 ** 2,
                            fwhm_radians=np.radians(0.5),
                            dtype=torch.float64, device="cpu", gen=gen,
                            dl_blocks=blocks)
    g = m.sht.grid
    arrays = {"d": n(m.d), "tau": n(m.noise.tau), "q_map": n(m.noise.q_map),
              "omega": m.noise.omega, "bl": n(m.bl), "spin": 3,
              "theta": g.theta, "weights": g.weights, "phi0": g.phi0,
              "nphi": g.nphi}
    ell = np.arange(LMAX + 1.0)
    fac = np.where(ell >= 2, 2 * np.pi / np.maximum(ell * (ell + 1), 1), 0)
    cl = np.stack([blocks * fac[:, None, None] * s for s in (0.8, 1.0, 1.3)])
    nst = 2 * (LMAX + 1) ** 2
    rng = np.random.default_rng(1)
    s0 = synfast_joint(cl, LMAX, dtype=torch.float64, device="cpu",
                       gen=gen).numpy()
    xi = rng.normal(size=(NCH - 1, 3, nst))
    chi2 = rng.chisquare(df=(2 * ell[:, None] + 1 - np.arange(3)).clip(1),
                         size=(NCH - 1, LMAX + 1, 3))
    normals = rng.normal(size=(NCH - 1, LMAX + 1, 3, 3))
    out = {}
    for dev in ("cpu", cuda_device):
        sch = JointCenteredGibbs(model_from_numpy(arrays, device=dev))
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        st, info = sch.step(state_from_numpy(s0, cl=cl, device=dev),
                            noise={"xi": t(xi)}, chi2=t(chi2),
                            normals=t(normals))
        out[str(dev)] = (n(sch.bt_ninv_d), n(st.s), n(st.cl),
                         n(info["dl"][0]))
    for a, b in zip(out[str(cuda_device)], out["cpu"]):
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()


@pytest.mark.cuda
@pytest.mark.parametrize("mdomain,engine", [(False, "phi"), ("m", "coef")])
def test_mh_engine_sweep_card_matches_cpu(cuda_device, mdomain, engine):
    """One nc_cls_sample_cut sweep on the phi-domain or the coefficient
    m-domain engine at lmax 16 in float64 (band mask, EE one block, BB a
    big block then single-bin blocks), card against CPU on the same
    uniforms: D_ell to 1e-9, accepts equal."""
    from gibbssampler_tpu_torch.harmonics import ell_mask_state
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    lmax = 16
    gen = torch.Generator().manual_seed(3)
    grid = gauss_legendre_grid(lmax)
    keep = (np.abs(np.pi / 2 - grid.theta) > 0.2).astype(np.float64)
    dls = np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")])
    m, _ = simulate_dataset(lmax, 2, dls, 0.2 ** 2, mask=np.broadcast_to(
        keep[:, None], (grid.nrings, grid.nphi)), dtype=torch.float64,
        device="cpu", gen=gen)
    bins = [np.arange(2, lmax + 2)] * 2
    nb = lmax - 1
    blocks = [[(0, nb)], [(0, 6)] + [(i, i + 1) for i in range(6, nb)]]
    dl0 = [np.maximum(d[2:], 1e-3) for d in dls]
    sig = [0.3 * d for d in dl0]
    rng = np.random.default_rng(4)
    dl = [d * np.exp(0.2 * rng.normal(size=(NCH, nb))) for d in dl0]
    s_nc = rng.normal(size=(NCH, 2, m.nstate)) * ell_mask_state(lmax)
    up = rng.uniform(size=(NCH, 1, 2 * nb))
    ua = rng.uniform(size=(NCH, 1, 1 + len(blocks[1])))
    out = []
    for device in ("cpu", cuda_device):
        model = with_cut_decomposition(_model_on(m, device))
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        plan = cs.CutMHPlan(model, bins, blocks, sig, mdomain=mdomain,
                            dtype=torch.float64)
        assert plan.engine == engine
        res = cs.nc_cls_sample_cut(tuple(t(d) for d in dl), t(s_nc), model,
                                   bins, blocks, sig, u_prop=t(up),
                                   u_acc=t(ua), plan=plan)
        out.append([n(a) for a in (*res[0], *res[1].accept)])
    for a, b in zip(out[0][:2], out[1][:2]):
        np.testing.assert_allclose(b, a, rtol=1e-9)
    for a, b in zip(out[0][2:], out[1][2:]):
        np.testing.assert_array_equal(b, a)
    acc = np.concatenate([a.ravel() for a in out[0][2:]])
    assert 0.0 < acc.mean() < 1.0


def _model_on(model, device):
    """The CPU dataset ``model`` rebuilt on ``device`` through
    ``model_from_numpy``."""
    g = model.sht.grid
    return model_from_numpy(
        {"d": n(model.d), "tau": n(model.noise.tau),
         "q_map": n(model.noise.q_map), "omega": model.noise.omega,
         "bl": n(model.bl), "spin": 2, "theta": g.theta,
         "weights": g.weights, "phi0": g.phi0, "nphi": g.nphi}, device)
