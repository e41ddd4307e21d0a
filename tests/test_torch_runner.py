"""The port's experiment runner against the JAX package's, on the CPU in
float64: what ``_build`` makes of a configuration (bins, MH blocks, the
initial spectrum, the analytic proposal scales, f_sky; the cut model of
JAX's own dataset), the results file's keys, shapes and configuration
JSON, the proposal scales pooled from a results file the JAX runner
wrote; the port's crash-and-resume bit for bit; the timing helpers; and a
mirror of every case of tests/test_runner.py."""

import json
import os

import numpy as np
import pytest
import torch

from torch_parity import jax_model_arrays, n
from gibbssampler_tpu.inference import RunConfig as JaxRunConfig
from gibbssampler_tpu.inference import run_experiment as jax_run
from gibbssampler_tpu.inference.fits_io import \
    write_healpix_map as jax_write_map
from gibbssampler_tpu.inference.runner import _build as jax_build
from gibbssampler_tpu.sht.healpix_pix import \
    galactic_band_mask as jax_band_mask
from gibbssampler_tpu_torch.diagnostics import (PhaseTimer, profile_trace,
                                                step_phase_times)
from gibbssampler_tpu_torch.inference import (RunConfig, load_checkpoint,
                                              load_cls, run_experiment,
                                              save_checkpoint,
                                              write_healpix_map)
from gibbssampler_tpu_torch.inference.runner import _build, _with_cut
from gibbssampler_tpu_torch.interop import model_from_numpy
from gibbssampler_tpu_torch.schemes import GibbsState, JointState
from gibbssampler_tpu_torch.sht import galactic_band_mask

CPU = "cpu"


def quiet(*a):
    pass


def both(**kw):
    """The same configuration for both runners."""
    return JaxRunConfig(**kw), RunConfig(**kw)


@pytest.fixture(scope="module")
def mask_fits(tmp_path_factory):
    """galactic_band_mask(16, 15 deg) in NESTED order, by the JAX
    writer."""
    path = str(tmp_path_factory.mktemp("fits") / "mask.fits")
    jax_write_map(path, jax_band_mask(16, 15.0), ordering="NESTED")
    return path


BUILDS = {
    "gl_band": dict(lmax=12, spin=2, scheme="asis", mask_band_deg=10.0,
                    noise_sigma2=0.04, fwhm_deg=1.0),
    "healpix_band": dict(lmax=16, spin=0, grid="healpix", nside=8,
                         scheme="asis", mask_band_deg=10.0, noise_sigma2=5.0),
    "healpix_fits": dict(lmax=16, spin=2, grid="healpix", nside=8,
                         scheme="asis", noise_sigma2=0.5, blocks_size=3),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_matches_jax(name, mask_fits):
    """Bins, MH blocks, the initial spectrum, the analytic proposal scales
    with their f_sky, and the cut decomposition's rows."""
    kw = dict(BUILDS[name], dtype="float64")
    if name == "healpix_fits":
        kw["mask_fits"] = mask_fits
    jcfg, tcfg = both(**kw)
    jsch, jdl0, _ = jax_build(jcfg)
    tsch, tdl0, _ = _build(tcfg, device=CPU)
    for a, b in zip(tsch.bins_list, jsch.bins_list):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [list(b) for b in tsch.blocks_list] == \
        [[tuple(map(int, x)) for x in b] for b in jsch.blocks_list]
    assert len(tdl0) == len(jdl0)
    for a, b in zip(tdl0, jdl0):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-13)
    np.testing.assert_allclose(n(tsch.model.noise.f_sky),
                               np.asarray(jsch.model.noise.f_sky),
                               rtol=1e-13)
    for a, b in zip(tsch.prop_sigma_list, jsch.prop_sigma_list):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12)
    assert tsch.model.has_cut and jsch.model.has_cut
    assert tsch.model.cut_sht.nrings == jsch.model.cut_sht.nrings
    if name == "healpix_fits":
        assert 0.5 < float(tsch.model.noise.f_sky[0]) < 0.95


CUTS = {
    "gl_spin2": dict(lmax=12, spin=2, scheme="asis", mask_band_deg=10.0,
                     noise_sigma2=0.04, fwhm_deg=1.0),
    "healpix_spin2": dict(lmax=16, spin=2, grid="healpix", nside=8,
                          scheme="centered", mask_band_deg=20.0),
    "gl_joint": dict(lmax=10, spin=3, scheme="joint", cr_method="cg",
                     mask_band_deg=15.0, r_te=0.5, noise_sigma2=0.5),
}


@pytest.mark.parametrize("name", sorted(CUTS))
def test_cut_model_of_jax_dataset(name):
    """JAX's dataset, carried across through interop, gets the same cut
    decomposition from the port's runner as from JAX's."""
    jcfg, tcfg = both(**CUTS[name], dtype="float64")
    jm = jax_build(jcfg)[0].model
    tm = _with_cut(tcfg, model_from_numpy(jax_model_arrays(jm), device=CPU))
    assert tm.has_cut and tm.has_sparse == jm.has_sparse
    assert tm.nfields == jm.nfields
    for f in ("w_cut", "d_cut", "cut_c1"):
        a, b = n(getattr(tm, f)), np.asarray(getattr(jm, f))
        np.testing.assert_allclose(a, b, atol=1e-12 * np.abs(b).max())
    np.testing.assert_allclose(float(tm.cut_c0), float(jm.cut_c0),
                               rtol=1e-12)
    np.testing.assert_allclose(tm.cut_sht.grid.theta,
                               jm.cut_sht.grid.theta, rtol=1e-15)
    assert tm.cut_w_uniform == jm.cut_w_uniform


RUNS = {
    "centered": dict(lmax=10, spin=0, scheme="centered", n_iter=6,
                     nchains=2, segment=3, time_steps=True),
    "asis_allsph": dict(lmax=10, spin=0, scheme="asis", n_iter=6, nchains=2,
                        segment=3, all_sph=True, noise_sigma2=50.0,
                        blocks_size=4),
    "pncp": dict(lmax=10, spin=2, scheme="pncp", cr_method="aux_gibbs",
                 mask_band_deg=10.0, l_cut=6, n_iter=6, nchains=2, segment=4,
                 blocks_size=4),
    "joint": dict(lmax=10, spin=3, scheme="joint", n_iter=6, nchains=2,
                  segment=3, time_steps=True),
}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """Each RUNS configuration through the JAX runner: {name: (path,
    results)}."""
    d = tmp_path_factory.mktemp("jax_runs")
    out = {}
    for name, kw in RUNS.items():
        path = str(d / f"{name}.npz")
        cfg = JaxRunConfig(**kw, dtype="float64", out=path)
        jax_run(cfg, verbose=quiet)
        out[name] = path
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_results_schema_matches_jax(name, jax_results, tmp_path):
    """The same keys, array shapes and configuration JSON as the JAX
    runner's results file for the same RunConfig."""
    path = str(tmp_path / "port.npz")
    res = run_experiment(RunConfig(**RUNS[name], dtype="float64", out=path),
                         verbose=quiet, device=CPU)
    with np.load(jax_results[name]) as zj, np.load(path) as zt:
        assert sorted(zt.files) == sorted(zj.files) == sorted(res)
        for k in zj.files:
            assert zt[k].shape == zj[k].shape, k
        cfg_j = json.loads(str(zj["config"]))
        cfg_j["out"] = path
        assert json.loads(str(zt["config"])) == cfg_j
    assert not os.path.exists(path + ".ckpt.npz")


class Crash(Exception):
    pass


def crash_after_first_segment(msg):
    if str(msg).startswith("segment done"):
        raise Crash(msg)


RESUMES = {
    "asis": dict(lmax=10, spin=2, scheme="asis", cr_method="aux_gibbs",
                 cr_options={"n_gibbs": 2}, mask_band_deg=10.0,
                 noise_sigma2=0.04, n_iter=9, nchains=2, segment=3,
                 blocks_size=4, time_steps=True),
    "joint": dict(lmax=10, spin=3, scheme="joint", r_te=0.5, n_iter=9,
                  nchains=2, segment=3, time_steps=True),
}


@pytest.mark.parametrize("name", sorted(RESUMES))
def test_crash_and_resume_is_bit_exact(name, tmp_path):
    """A run crashed by its verbose callback after the first segment's
    checkpoint, then resumed, writes the uninterrupted run's chains and
    acceptance histories bit for bit; the checkpoint is gone after."""
    ref_path = str(tmp_path / "ref.npz")
    ref = run_experiment(RunConfig(**RESUMES[name], dtype="float64",
                                   out=ref_path), verbose=quiet, device=CPU)
    path = str(tmp_path / "crashed.npz")
    cfg = RunConfig(**RESUMES[name], dtype="float64", out=path)
    with pytest.raises(Crash):
        run_experiment(cfg, verbose=crash_after_first_segment, device=CPU)
    assert os.path.exists(path + ".ckpt.npz") and not os.path.exists(path)
    logs = []
    res = run_experiment(cfg, resume=True, verbose=logs.append, device=CPU)
    assert logs[0] == "resumed at iteration 3"
    assert not os.path.exists(path + ".ckpt.npz")
    timed = {"durations", "step_time_cr", "step_time_cls", "step_time_full",
             "config"}
    assert sorted(res) == sorted(ref)
    for k in sorted(set(ref) - timed):
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    for k in timed - {"config"}:
        assert res[k].shape == ref[k].shape == (3,), k
    assert "mh_accept_0" in res or name == "joint"


def test_proposal_from_jax_results(tmp_path):
    """A results file written by the JAX runner pools into JAX's proposal
    scales (per bin 2.38 sd / sqrt(block width))."""
    path = str(tmp_path / "prelim.npz")
    kw = dict(lmax=12, spin=0, scheme="asis", n_iter=20, nchains=3,
              segment=20, dtype="float64", all_sph=True, noise_sigma2=5e3,
              blocks_size=3)
    jax_run(JaxRunConfig(**kw, out=path), verbose=quiet)
    jcfg, tcfg = both(**{**kw, "proposal_from": path, "seed": 3})
    jsig = jax_build(jcfg)[0].prop_sigma_list
    tsig = _build(tcfg, device=CPU)[0].prop_sigma_list
    assert len(tsig) == len(jsig) == 1
    np.testing.assert_allclose(tsig[0], np.asarray(jsig[0]), rtol=1e-12)
    with pytest.raises(ValueError, match="incompatible"):
        _build(RunConfig(**{**kw, "lmax": 10, "proposal_from": path}),
               device=CPU)


def test_step_phase_times_leave_the_run_alone():
    """The timing probe leaves the state, the chains' generator and the
    scheme's CR step as they were, and reports each sub-step's time, the
    C_ell step's from calls of its own."""
    sch, dl0, _ = _build(RunConfig(**RESUMES["asis"], dtype="float64"),
                         device=CPU)
    gen = torch.Generator().manual_seed(0)
    state = sch.init_state(dl0, 2, gen)
    before = [t.clone() for t in (state.s, *state.dl)]
    g_state = gen.get_state()
    cr_step = sch._cr_step
    pt = step_phase_times(sch, state, torch.Generator().manual_seed(1),
                          reps=2)
    for a, b in zip(before, (state.s, *state.dl)):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), g_state)
    assert sch._cr_step is cr_step
    assert sorted(pt) == ["cls", "cr", "full"]
    assert pt["full"] > 0 and pt["cr"] > 0 and pt["cls"] > 0


def test_phase_timer_and_profile_trace(tmp_path):
    timer = PhaseTimer()
    for _ in range(3):
        with timer("step", block_on={"x": (torch.ones(3),)}):
            torch.ones(100).sum()
    s = timer.summary()
    assert s["step"]["count"] == 3 and len(timer.history["step"]) == 3
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)) as prof:
        torch.ones(1000).cumsum(0)
    assert prof is not None and any(logdir.iterdir())


def test_checkpoint_round_trip(tmp_path):
    """Both state kinds and the histories come back as saved."""
    gen = torch.Generator().manual_seed(4)
    torch.randn(5, generator=gen)
    rng = np.random.default_rng(0)
    for state in (GibbsState(s=torch.as_tensor(rng.normal(size=(2, 1, 8))),
                             dl=(torch.as_tensor(rng.normal(size=(2, 3))),)),
                  JointState(s=torch.as_tensor(rng.normal(size=(2, 3, 8))),
                             cl=torch.as_tensor(rng.normal(
                                 size=(2, 2, 3, 3))))):
        path = str(tmp_path / "ck.npz")
        hist = {"cr_accept_chain": rng.normal(size=(2, 4)),
                "durations": np.array([1.0, 2.0])}
        save_checkpoint(path, gen.get_state(), state, [np.ones((2, 4, 3))],
                        4, hist)
        ck = load_checkpoint(path, device=CPU)
        assert ck["iters_done"] == 4 and type(ck["state"]) is type(state)
        for a, b in zip(ck["state"], state):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
        g2 = torch.Generator()
        g2.set_state(ck["key"])
        assert torch.equal(torch.randn(4, generator=g2),
                           torch.randn(4, generator=gen))
        assert sorted(ck["histories"]) == sorted(hist)
        assert len(ck["chains"]) == 1
    assert load_checkpoint(str(tmp_path / "none.npz"), device=CPU) is None


def test_chip_smoke_runner_keys_match_jax(tmp_path):
    """The results keys chip_smoke.py holds its lmax-512 runner phase to
    are those the JAX runner writes for that configuration (run here at
    lmax 10, two chains)."""
    import chip_smoke
    path = str(tmp_path / "r.npz")
    kw = dict(chip_smoke.RUNNER_CFG, lmax=10, nchains=2, n_iter=4, segment=2,
              dtype="float64", cr_options={"n_gibbs": 2})
    res = jax_run(JaxRunConfig(**kw, out=path), verbose=quiet)
    assert sorted(res) == chip_smoke.RUNNER_KEYS
    assert sorted(run_experiment(RunConfig(**kw, out=path), verbose=quiet,
                                 device=CPU)) == chip_smoke.RUNNER_KEYS


def test_runconfig_matches_jax_and_runs_on_the_card():
    """RunConfig has the JAX runner's fields and defaults; without a card
    the runner's default device fails, with no CPU fallback."""
    import dataclasses
    assert [f.name for f in dataclasses.fields(RunConfig)] == \
        [f.name for f in dataclasses.fields(JaxRunConfig)]
    assert RunConfig() == RunConfig(**{
        f.name: getattr(JaxRunConfig(), f.name)
        for f in dataclasses.fields(RunConfig)})
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            run_experiment(RunConfig(lmax=4, n_iter=1), verbose=quiet)


# ---- mirrors of tests/test_runner.py ------------------------------------

def test_run_experiment_and_resume(tmp_path):
    out = str(tmp_path / "res.npz")
    cfg = RunConfig(lmax=12, spin=0, scheme="centered", cr_method="exact",
                    n_iter=40, nchains=2, segment=15, dtype="float64",
                    out=out, noise_sigma2=1.0)
    run_experiment(cfg, verbose=quiet, device=CPU)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 40, 11)
    assert np.isfinite(z["dl_chain_0"]).all()
    assert len(z["durations"]) == 3
    assert not os.path.exists(out + ".ckpt.npz")
    # a checkpoint made by hand at iteration 10, then resumed
    out2 = str(tmp_path / "res2.npz")
    cfg2 = RunConfig(**{**cfg.__dict__, "n_iter": 30, "segment": 10,
                        "out": out2})
    run_experiment(RunConfig(**{**cfg2.__dict__, "n_iter": 10}),
                   verbose=quiet, device=CPU)
    z10 = np.load(out2)
    state = GibbsState(s=torch.zeros((2, 1, 338), dtype=torch.float64),
                       dl=(torch.as_tensor(z10["dl_chain_0"][:, -1, :]),))
    save_checkpoint(out2 + ".ckpt.npz",
                    torch.Generator().manual_seed(9).get_state(), state,
                    [z10["dl_chain_0"]], 10)
    logs = []
    run_experiment(cfg2, resume=True, verbose=logs.append, device=CPU)
    assert any("resumed at iteration 10" in str(m) for m in logs)
    assert np.load(out2)["dl_chain_0"].shape == (2, 30, 11)


def test_run_experiment_asis_allsph(tmp_path):
    out = str(tmp_path / "asis.npz")
    run_experiment(RunConfig(lmax=12, spin=0, scheme="asis",
                             cr_method="exact", n_iter=20, nchains=2,
                             segment=20, dtype="float64", out=out,
                             all_sph=True, noise_sigma2=50.0, blocks_size=4),
                   verbose=quiet, device=CPU)
    z = np.load(out)
    assert np.isfinite(z["dl_chain_0"]).all()
    assert z["ess_0"].shape == (11,)


def test_load_cls(tmp_path):
    arr = np.stack([np.arange(20.0), np.ones(20), np.zeros(20), np.ones(20)])
    p = str(tmp_path / "cls.npy")
    np.save(p, arr)
    out = load_cls(p, lmax=15)
    assert out["tt"].shape == (16,)
    assert out["tt"][0] == 0 and out["tt"][1] == 0 and out["tt"][5] == 5.0
    txt = str(tmp_path / "cls.txt")
    ell = np.arange(2, 16)
    np.savetxt(txt, np.column_stack([ell, np.ones_like(ell, dtype=float)]))
    out2 = load_cls(txt, lmax=15, columns=("tt",), input_is_dl=False)
    assert np.isclose(out2["tt"][10], 10 * 11 / (2 * np.pi))


def test_run_experiment_healpix_grid(tmp_path):
    out = str(tmp_path / "hp.npz")
    run_experiment(RunConfig(lmax=16, spin=0, grid="healpix", nside=8,
                             scheme="centered", cr_method="cg",
                             cr_options={"cg_tol": 1e-7, "cg_maxiter": 200},
                             mask_band_deg=10.0, n_iter=20, nchains=2,
                             segment=20, dtype="float64", out=out,
                             noise_sigma2=5.0), verbose=quiet, device=CPU)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 20, 15)
    assert np.isfinite(z["dl_chain_0"]).all()


def test_run_experiment_mask_fits(tmp_path):
    fits = str(tmp_path / "mask.fits")
    write_healpix_map(fits, galactic_band_mask(16, 15.0), ordering="RING")
    out = str(tmp_path / "mf.npz")
    cfg = RunConfig(lmax=16, spin=0, grid="healpix", nside=8,
                    scheme="centered", cr_method="cg",
                    cr_options={"cg_tol": 1e-7, "cg_maxiter": 300},
                    mask_fits=fits, n_iter=10, nchains=2, segment=10,
                    dtype="float64", out=out, noise_sigma2=5.0)
    scheme, _, _ = _build(cfg, device=CPU)
    assert 0.5 < float(scheme.model.noise.f_sky[0]) < 0.95
    run_experiment(cfg, verbose=quiet, device=CPU)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 10, 15)
    assert np.isfinite(z["dl_chain_0"]).all()
    with pytest.raises(ValueError, match="mask_fits"):
        _build(RunConfig(lmax=16, grid="gl", mask_fits=fits), device=CPU)


def test_run_experiment_joint(tmp_path):
    out = str(tmp_path / "joint.npz")
    run_experiment(RunConfig(lmax=10, spin=3, scheme="joint", n_iter=20,
                             nchains=2, segment=8, dtype="float64", out=out,
                             noise_sigma2=0.5, time_steps=True),
                   verbose=quiet, device=CPU)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 20, 11, 3, 3)
    assert np.isfinite(z["dl_chain_0"]).all()
    assert len(z["durations"]) == 3
    assert not os.path.exists(out + ".ckpt.npz")
    assert z["cr_accept_chain"].shape[1] == 20
    assert z["step_time_full"].shape == (3,)
    assert z["ess_0"].shape == (54,) and np.isfinite(z["ess_0"]).all()


def test_run_experiment_joint_crash_resume(tmp_path):
    out = str(tmp_path / "jr.npz")
    cfg = RunConfig(lmax=10, spin=3, scheme="joint", n_iter=24, nchains=2,
                    segment=8, dtype="float64", out=out, noise_sigma2=0.5)
    run_experiment(RunConfig(**{**cfg.__dict__, "n_iter": 8}),
                   verbose=quiet, device=CPU)
    z8 = np.load(out)
    state = JointState(s=torch.zeros((2, 3, 2 * 11 * 11),
                                     dtype=torch.float64),
                       cl=torch.as_tensor(z8["dl_chain_0"][:, -1]))
    save_checkpoint(out + ".ckpt.npz",
                    torch.Generator().manual_seed(9).get_state(), state,
                    [z8["dl_chain_0"]], 8)
    logs = []
    run_experiment(cfg, resume=True, verbose=logs.append, device=CPU)
    assert any("resumed at iteration 8" in str(m) for m in logs)
    z = np.load(out)
    assert z["dl_chain_0"].shape == (2, 24, 11, 3, 3)
    assert np.isfinite(z["dl_chain_0"]).all()


def test_run_experiment_joint_te_masked(tmp_path):
    """Correlated TQU data on a masked sky: the joint scheme's CG path
    recovers r_te; the uncorrelated default stays near 0."""
    out = str(tmp_path / "jte.npz")
    r_te = 0.7
    cfg = RunConfig(lmax=10, spin=3, scheme="joint", cr_method="cg",
                    cr_options={"cg_tol": 1e-8, "cg_maxiter": 400},
                    r_te=r_te, mask_band_deg=15.0, n_iter=150, nchains=4,
                    dtype="float64", out=out, noise_sigma2=1e-3)
    run_experiment(cfg, verbose=quiet, device=CPU)
    chain = np.load(out)["dl_chain_0"]
    assert np.isfinite(chain).all()
    post = chain[:, 50:].mean(axis=(0, 1))
    r = post[4:, 0, 1] / np.sqrt(post[4:, 0, 0] * post[4:, 1, 1])
    assert abs(float(r.mean()) - r_te) < 0.25, r
    out2 = str(tmp_path / "jte0.npz")
    run_experiment(RunConfig(**{**cfg.__dict__, "r_te": 0.0, "out": out2,
                                "n_iter": 100}), verbose=quiet, device=CPU)
    post0 = np.load(out2)["dl_chain_0"][:, 40:].mean(axis=(0, 1))
    r0 = post0[4:, 0, 1] / np.sqrt(post0[4:, 0, 0] * post0[4:, 1, 1])
    assert abs(float(r0.mean())) < 0.3, r0


def test_runner_step_phase_times(tmp_path):
    out = str(tmp_path / "pt.npz")
    run_experiment(RunConfig(lmax=12, spin=0, scheme="asis",
                             cr_method="exact", n_iter=20, nchains=2,
                             segment=10, dtype="float64", out=out,
                             all_sph=True, noise_sigma2=50.0, blocks_size=4,
                             time_steps=True), verbose=quiet, device=CPU)
    z = np.load(out)
    assert z["step_time_cr"].shape == (2,)
    assert z["step_time_cls"].shape == (2,)
    assert (z["step_time_full"] > 0).all()
    assert (z["step_time_cr"] >= 0).all() and (z["step_time_cls"] >= 0).all()


def test_analytic_proposal_sigma_formula():
    from gibbssampler_tpu_torch.parallel import analytic_proposal_sigma
    lmax = 16
    bl = np.exp(-0.001 * np.arange(lmax + 1) ** 2)
    omega, noise = 4 * np.pi / (12 * 64), 0.04
    bins = np.array([2, 5, 9, 17])
    sig = analytic_proposal_sigma(bl, noise, omega, lmax, bins, f_sky=0.8)
    for b, (lo, hi) in enumerate(zip(bins[:-1], bins[1:])):
        acc = [2.0 / (2 * l + 1) * (l * (l + 1) / (2 * np.pi) * omega
                                     * noise / bl[l] ** 2) ** 2 / 0.8
               for l in range(lo, hi)]
        np.testing.assert_allclose(sig[b], np.sqrt(np.mean(acc) / (hi - lo)),
                                   rtol=1e-12)


def test_preliminary_run_proposal_reload(tmp_path):
    from gibbssampler_tpu_torch.parallel import proposal_sigmas_from_results
    out1 = str(tmp_path / "prelim.npz")
    cfg1 = RunConfig(lmax=12, spin=0, scheme="asis", cr_method="exact",
                     n_iter=60, nchains=4, segment=60, dtype="float64",
                     out=out1, all_sph=True, noise_sigma2=5e3, blocks_size=1)
    run_experiment(cfg1, verbose=quiet, device=CPU)
    sig = proposal_sigmas_from_results(out1, nfields=1)
    assert len(sig) == 1 and sig[0].shape == (11,) and (sig[0] > 0).all()
    c = np.load(out1)["dl_chain_0"][:, 12:].reshape(-1, 11)
    np.testing.assert_allclose(
        sig[0], np.maximum(2.38 * c.std(axis=0), 1e-12), rtol=1e-12)
    out2 = str(tmp_path / "tuned.npz")
    run_experiment(RunConfig(**{**cfg1.__dict__, "out": out2,
                                "proposal_from": out1, "n_iter": 30,
                                "segment": 30, "seed": 3}),
                   verbose=quiet, device=CPU)
    z2 = np.load(out2)
    assert np.isfinite(z2["dl_chain_0"]).all()
    assert z2["mh_accept_0"].mean() > 0.05


def test_runner_saves_acceptance_histories(tmp_path):
    out = str(tmp_path / "acc.npz")
    run_experiment(RunConfig(lmax=12, spin=0, scheme="asis",
                             cr_method="exact", n_iter=20, nchains=2,
                             segment=10, dtype="float64", out=out,
                             all_sph=True, noise_sigma2=50.0, blocks_size=4),
                   verbose=quiet, device=CPU)
    z = np.load(out)
    assert z["cr_accept_chain"].shape == (2, 20)
    a = z["mh_accept_0"]
    assert a.shape == (2, 20, -(-11 // 4))
    assert ((a >= 0) & (a <= 1)).all() and a.mean() > 0.01
