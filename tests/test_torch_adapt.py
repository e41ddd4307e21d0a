"""The port's proposal-scale machinery: the pooled scales and the warm-up
adaptation against the JAX package's (numpy inputs, stub schemes), the
in-place scale swap of ``ASISGibbs``, the tuned records and their reader,
the flagship configurations' bins and blocks, and the tuner at a tiny size
(float64 unless stated, CPU)."""

import json
import pathlib

import numpy as np
import jax
import pytest
import torch

from torch_parity import n, t64
from gibbssampler_tpu.parallel import adapt as jax_adapt
from gibbssampler_tpu_torch import flagship, tune
from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
from gibbssampler_tpu_torch.interop import port_tuned_proposal_sigmas
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.parallel import adapt
from gibbssampler_tpu_torch.schemes import ASISGibbs
from gibbssampler_tpu_torch.schemes.gibbs import GibbsState

ROOT = pathlib.Path(__file__).resolve().parent.parent
LMAX = 12
BINS = [np.arange(2, LMAX + 2), np.array([2, 3, 4, 5, 6, 7, 8, 10, 11, 13])]
BLOCKS = [[(0, 11)], [(0, 3)] + [(i, i + 1) for i in range(3, 9)]]
OPTS = {"n_gibbs": 1, "tau": 0.02}


# ---------------------------------------------------------------------------
# Pooled scales
# ---------------------------------------------------------------------------

def test_pooled_and_results_sigmas_match_jax(tmp_path):
    """pooled_proposal_sigmas (with and without block widths) and
    proposal_sigmas_from_results on the same seeded chains and npz."""
    rng = np.random.default_rng(0)
    chains = [np.exp(rng.normal(size=(4, 30, nb))) for nb in (7, 5)]
    blocks = [[(0, 4), (4, 7)], [(0, 1), (1, 5)]]
    for c, bl in zip(chains, blocks):
        bw = adapt.block_widths(bl, c.shape[-1])
        for kw in ({}, {"block_width": bw}, {"scale": 1.0, "floor": 1e-3}):
            np.testing.assert_allclose(
                adapt.pooled_proposal_sigmas(c, **kw),
                jax_adapt.pooled_proposal_sigmas(c, **kw), rtol=1e-12)
    path = tmp_path / "run.npz"
    np.savez(path, dl_chain_1=chains[1], dl_chain_0=chains[0],
             other=np.zeros(3))
    for kw in ({}, {"blocks_list": blocks}, {"nfields": 1, "burn_frac": 0.5}):
        mine = adapt.proposal_sigmas_from_results(path, **kw)
        ref = jax_adapt.proposal_sigmas_from_results(path, **kw)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            np.testing.assert_allclose(a, b, rtol=1e-12)


# ---------------------------------------------------------------------------
# adapt_segments against the JAX package's, through stub schemes
# ---------------------------------------------------------------------------

STUB_BLOCKS = [[(0, 3), (3, 5)], [(0, 2), (2, 3), (3, 6)]]
# per-block acceptances per segment: below 0.06 (factor floored at 0.3),
# in (0.06, 0.2), in the window, above it
STUB_ACC = [[[0.03, 0.75], [0.12, 0.35, 1.0]],
            [[0.35, 0.12], [0.75, 0.03, 0.5]],
            [[0.2, 0.55], [0.0, 0.9, 0.18]]]
NCH, NIT = 4, 25


def _history(seg, kind):
    """A segment's fixed run output: seeded D_ell chains and accept
    indicators with exactly the acceptances of STUB_ACC."""
    rng = np.random.default_rng(100 + seg)
    out = {"dl_chains": tuple(np.exp(rng.normal(size=(NCH, NIT, hi[-1][1])))
                              for hi in STUB_BLOCKS)}
    if kind != "no_mh":
        acc = []
        for f, probs in enumerate(STUB_ACC[seg]):
            a = np.zeros((NCH * NIT, len(probs)))
            for b, p in enumerate(probs):
                a[:int(round(p * NCH * NIT)), b] = 1.0
            acc.append(rng.permutation(a).reshape(NCH, NIT, len(probs)))
        out["mh_accept"] = tuple(acc)
    return out


class _Stub:
    """What adapt_segments reads of a scheme; ``kind`` "blocks" exposes
    the blocks, "global" hides them (one factor per field), "no_mh" has no
    MH accept history."""

    def __init__(self, sig, kind, log, swap=False):
        self.kind, self.log = kind, log
        self.seen = [[s.copy() for s in sig]]
        if kind == "blocks":
            self.blocks_list = STUB_BLOCKS
        if swap:
            self.set_proposal_sigmas = lambda s: self.seen.append(
                [x.copy() for x in s])

    def _run(self, dl_init):
        self.log.append(tuple(np.asarray(d) for d in dl_init))
        return _history(len(self.log) - 1, self.kind)


class _JaxStub(_Stub):
    def run(self, key, dl_init, n_iter, nchains):
        return self._run(dl_init)


class _PortStub(_Stub):
    def run(self, dl_init, n_iter, nchains, gen=None):
        out = self._run(dl_init)
        return {k: tuple(t64(x) for x in v) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["blocks", "global", "no_mh"])
@pytest.mark.parametrize("swap", [False, True])
def test_adapt_segments_matches_jax(kind, swap):
    """Three segments of fixed histories: the port's adapt_segments gives
    JAX's sigmas and warm starts (to 1e-12) through every branch of the
    rule; a scheme with set_proposal_sigmas is built once and handed each
    segment's scales."""
    sig0 = [np.linspace(1.0, 2.0, 5), np.linspace(0.5, 3.0, 6)]
    dl0 = (np.ones(5), np.full(6, 2.0))
    jlog, tlog, made = [], [], []

    def make_j(sig):
        return _JaxStub(sig, kind, jlog)

    def make_t(sig):
        made.append(_PortStub(sig, kind, tlog, swap))
        return made[-1]

    ref = jax_adapt.adapt_segments(make_j, jax.random.PRNGKey(0), dl0, sig0,
                                   n_segments=3, seg_iters=NIT, nchains=NCH)
    mine = adapt.adapt_segments(make_t, torch.Generator().manual_seed(0),
                                dl0, sig0, n_segments=3, seg_iters=NIT,
                                nchains=NCH)
    for a, b in zip(mine[0], ref[0]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for a, b in zip(mine[1], ref[1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for a, b in zip(tlog, jlog):          # every segment's warm start
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
    assert len(made) == (1 if swap else 3)
    if kind == "no_mh":
        for a, s in zip(mine[0], sig0):
            np.testing.assert_array_equal(a, s)
    elif kind == "blocks":
        # every branch of the rule was taken: 0.3 floor, acc / 0.2, 1, and
        # 1 + 2 (acc - 0.5)
        r = mine[0][0] / sig0[0]
        assert not np.allclose(r, 1.0)
    if swap:
        assert len(made[0].seen) == 3


def _cut_model(lmax=LMAX, seed=0):
    gen = torch.Generator().manual_seed(seed)
    theta = np.arccos(np.polynomial.legendre.leggauss(lmax + 1)[0][::-1])
    keep = (np.abs(np.pi / 2 - theta) > 0.2).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (lmax + 1, 2 * lmax + 2))
    dls = np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")])
    model, _ = simulate_dataset(lmax, 2, dls, 0.2 ** 2,
                                fwhm_radians=np.radians(0.5), mask=mask,
                                dtype=torch.float64, device="cpu", gen=gen)
    dl0 = [flagship.binned_mean(d, b) for d, b in zip(dls, BINS)]
    return with_cut_decomposition(model), dl0


@pytest.fixture(scope="module")
def cut():
    return _cut_model()


def test_adapt_segments_opens_narrow_scales(cut):
    """Mirror of tests/test_parallel.py::test_adapt_segments_tunes_sigmas
    on a small cut ASIS model: from absurdly narrow scales, 2 segments
    open every block's scale up; the scheme is built once and its MH plan
    stays the same object."""
    model, dl0 = cut
    sig0 = [1e-4 * d for d in dl0]
    made, plans = [], []

    def make(sig):
        made.append(ASISGibbs(model, BINS, BLOCKS, sig, cr_method="aux_mala",
                              cr_options=OPTS))
        plans.append(made[-1].mh_plan)
        return made[-1]

    sig, warm, out = adapt.adapt_segments(
        make, torch.Generator().manual_seed(1), dl0, sig0, n_segments=2,
        seg_iters=6, nchains=3)
    assert len(made) == 1 and made[0].mh_plan is plans[0]
    for s, s0 in zip(sig, sig0):
        assert np.all(s > s0)
    for w, d in zip(warm, dl0):
        assert w.shape == d.shape and np.all(w > 0)
    assert np.isfinite(np.concatenate([n(a).ravel()
                                       for a in out["mh_accept"]])).all()


# ---------------------------------------------------------------------------
# The in-place scale swap
# ---------------------------------------------------------------------------

def _inputs(scheme, dl0, nch, seed):
    """A start state near ``dl0`` and one iteration's injected variates."""
    rng = np.random.default_rng(seed)
    m = scheme.model
    dls = tuple(np.tile(d, (nch, 1)) * np.exp(0.1 * rng.normal(
        size=(nch, len(d)))) for d in dl0)
    var = n(scheme.var_cls(tuple(t64(d) for d in dls)))
    s0 = np.sqrt(var) * rng.normal(size=var.shape)
    ntot = sum(len(b) - 1 for b in BINS)
    kw = {"noise": {"state": t64(rng.normal(size=(nch, 2, 2, m.nstate))),
                    "aux": t64(rng.normal(size=(nch, 1)
                                          + tuple(m.w_cut.shape)))},
          "u": t64(rng.uniform(size=nch)),
          "gammas": tuple(t64(rng.gamma(3.0, size=(nch, len(b) - 1)))
                          for b in BINS),
          "u_prop": t64(rng.uniform(size=(nch, 1, ntot))),
          "u_acc": t64(rng.uniform(size=(nch, 1, sum(map(len, BLOCKS)))))}
    return GibbsState(s=t64(s0), dl=tuple(t64(d) for d in dls)), kw


def _plan_tensors(plan):
    out = [plan.sigma, plan.bmask]
    for c in plan.chunks:
        out += [c.j_idx, c.gbins, c.rows, c.lamA, c.lamB, c.W, c.omega]
    return out


def test_set_proposal_sigmas_equals_fresh_scheme(cut):
    """After set_proposal_sigmas one ASIS step equals, bitwise, the step of
    a scheme built with those scales, on the same injected variates; the
    plan and its tensors are the same objects, sigma changed in place."""
    model, dl0 = cut
    sig_a = [0.3 * d for d in dl0]
    sig_b = [0.05 * d for d in dl0]
    swapped = ASISGibbs(model, BINS, BLOCKS, sig_a, cr_method="aux_mala",
                        cr_options=OPTS)
    fresh = ASISGibbs(model, BINS, BLOCKS, sig_b, cr_method="aux_mala",
                      cr_options=OPTS)
    plan = swapped.mh_plan
    before = [id(x) for x in _plan_tensors(plan)]
    swapped.set_proposal_sigmas(sig_b)
    assert swapped.mh_plan is plan
    assert [id(x) for x in _plan_tensors(plan)] == before
    assert torch.equal(plan.sigma, fresh.mh_plan.sigma)
    state, kw = _inputs(swapped, dl0, 3, 4)
    a_state, a_info = swapped.step(state, **kw)
    b_state, b_info = fresh.step(state, **kw)
    assert torch.equal(a_state.s, b_state.s)
    for f in range(2):
        assert torch.equal(a_state.dl[f], b_state.dl[f])
        assert torch.equal(a_info["mh_accept"][f], b_info["mh_accept"][f])
    with pytest.raises(ValueError):
        swapped.set_proposal_sigmas(sig_b[:1])


def test_prop_sigma_list_assignment_reaches_both_engines(cut):
    """Assigning prop_sigma_list goes through set_proposal_sigmas: the
    table engine's plan takes the new scales, and its step equals the
    direct engine's built with them."""
    model, dl0 = cut
    sig_a = [0.3 * d for d in dl0]
    sig_b = [0.1 * d for d in dl0]
    table = ASISGibbs(model, BINS, BLOCKS, sig_a, cr_method="aux_mala",
                      cr_options=OPTS)
    direct = ASISGibbs(model, BINS, BLOCKS, sig_b, cr_method="aux_mala",
                       cr_options=OPTS, mh_fast="off")
    table.prop_sigma_list = sig_b
    np.testing.assert_array_equal(n(table.mh_plan.sigma),
                                  np.concatenate(sig_b))
    for a, b in zip(table.prop_sigma_list, sig_b):
        np.testing.assert_array_equal(a, b)
    state, kw = _inputs(table, dl0, 3, 5)
    a_state, a_info = table.step(state, **kw)
    b_state, b_info = direct.step(state, **kw)
    for f in range(2):
        np.testing.assert_allclose(n(a_state.dl[f]), n(b_state.dl[f]),
                                   rtol=1e-9)
        np.testing.assert_array_equal(n(a_info["mh_accept"][f]),
                                      n(b_info["mh_accept"][f]))


# ---------------------------------------------------------------------------
# Records and the flagship configurations
# ---------------------------------------------------------------------------

def test_port_tuned_records_round_trip(tmp_path):
    """write_record then port_tuned_proposal_sigmas: the record comes back;
    another mask or CR method raises LookupError; a second record of the
    same key replaces the first and leaves the others."""
    path = tmp_path / "tp.json"
    key = dict(scheme="asis", grid="gl", mask="band", lmax=12,
               nbins=[3, 2], cr="aux_mala")
    tune.write_record(path, {**key, "sig": [[1.0, 2.0, 3.0], [4.0, 5.0]]})
    tune.write_record(path, {**key, "cr": "overrelax",
                             "sig": [[7.0] * 3, [8.0] * 2]})
    sig = port_tuned_proposal_sigmas(path, "asis", "gl", "band", 12, [3, 2],
                                     "aux_mala")
    np.testing.assert_array_equal(sig[0], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(sig[1], [4.0, 5.0])
    for bad in (dict(mask="planckish"), dict(cr="exact"), dict(lmax=16),
                dict(nbins=[3, 3]), dict(grid="healpix")):
        with pytest.raises(LookupError):
            port_tuned_proposal_sigmas(path, **{**key, **bad})
    tune.write_record(path, {**key, "sig": [[9.0] * 3, [9.0] * 2]})
    recs = json.loads(path.read_text())["records"]
    assert len(recs) == 2
    np.testing.assert_array_equal(port_tuned_proposal_sigmas(
        path, **key)[0], [9.0] * 3)
    np.testing.assert_array_equal(port_tuned_proposal_sigmas(
        path, **{**key, "cr": "overrelax"})[0], [7.0] * 3)


def test_flagship_bins_and_blocks_follow_bench():
    """At lmax 512: 511 EE bins in one block; 410 BB bins, unit to l = 396
    then bench.py's 16 wide bins, a 277-bin block and 133 singles
    (bench.py:258-272).  Below l = 396 bench.py's smoke-test rule."""
    bins, blocks = flagship.asis_bins_blocks(512)
    wide = [396, 398, 400, 402, 406, 410, 415, 420, 425, 430, 435, 440, 445,
            460, 475, 495, 513]
    np.testing.assert_array_equal(bins[0], np.arange(2, 514))
    np.testing.assert_array_equal(bins[1], list(range(2, 396)) + wide)
    assert [len(b) - 1 for b in bins] == [511, 410]
    assert blocks[0] == [(0, 511)]
    assert blocks[1][0] == (0, 277) and len(blocks[1]) == 1 + 133
    assert blocks[1][1:] == [(i, i + 1) for i in range(277, 410)]
    bins, blocks = flagship.asis_bins_blocks(16)
    assert [len(b) - 1 for b in bins] == [15, 15]
    assert blocks[1][0] == (0, 10) and len(blocks[1]) == 6


def test_committed_records_have_provenance():
    """gibbssampler_tpu_torch/tuned_proposals.json holds the five card-tuned
    records (ASIS aux_mala on GL band, GL planckish and HEALPix planckish;
    ASIS overrelax on GL band; PNCP aux_mala on GL band with bench.py's
    l_cut) at lmax 512, each with 511 / 410 scales, its per-segment
    per-block acceptances, its run's sizes, dtype, card and commit."""
    path = ROOT / "gibbssampler_tpu_torch" / "tuned_proposals.json"
    recs = json.loads(path.read_text())["records"]
    keys = {(r["scheme"], r["grid"], r["mask"], r["cr"]) for r in recs}
    assert keys >= {("asis", "gl", "band", "aux_mala"),
                    ("asis", "gl", "planckish", "aux_mala"),
                    ("asis", "healpix", "planckish", "aux_mala"),
                    ("asis", "gl", "band", "overrelax"),
                    ("pncp", "gl", "band", "aux_mala")}
    # per field: blocks and l_cut of each scheme's flagship configuration
    blocks = {"asis": ([1, 134], None), "pncp": ([0, 112], [513, 300])}
    for r in recs:
        nblocks, l_cut = blocks[r["scheme"]]
        assert r["lmax"] == 512 and r.get("l_cut") == l_cut
        assert [len(s) for s in r["sig"]] == r["nbins"] == [511, 410]
        assert all(np.all(np.asarray(s) > 0) for s in r["sig"])
        assert len(r["accept_per_block_per_segment"]) == r["segments"]
        assert [len(a) for a in r["accept_per_block_per_segment"][-1]] \
            == nblocks
        assert r["dtype"] == "float32" and r["nchains"] > 0 \
            and r["seg_iters"] > 0
        assert "H100" in r["card"] and " W" in r["card"]
        assert len(r["commit"]) == 40
        sig = port_tuned_proposal_sigmas(path, r["scheme"], r["grid"],
                                         r["mask"], 512, [511, 410], r["cr"],
                                         l_cut=l_cut)
        np.testing.assert_array_equal(sig[1], r["sig"][1])


def test_flagship_build_reads_records_or_seeds(tmp_path):
    """flagship.build at lmax 16 on the CPU: with seed=True the analytic
    seeds; without, the record of its key, and LookupError when there is
    none (no fallback)."""
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"records": []}))
    with pytest.raises(LookupError):
        flagship.build("gl", "band", device="cpu", lmax=16, records=empty)
    scheme, dl0 = flagship.build("gl", "band", "overrelax", device="cpu",
                                 lmax=16, seed=True)
    assert scheme.cr_method == "overrelax"
    assert scheme.cr_options == flagship.CR_OPTIONS["overrelax"]
    assert [len(d) for d in dl0] == [15, 15]
    seeds = flagship.analytic_sigmas(scheme.model, scheme.bins_list)
    for a, b in zip(scheme.prop_sigma_list, seeds):
        np.testing.assert_array_equal(a, b)


def test_start_state_of_the_overrelaxed_cr(cut):
    """flagship.start_state: the scheme's own initial draw for aux_mala;
    for overrelax the aux_mala draw on the same generator, not the
    overrelaxed one, whose (1 - alpha) m start has a tenth of the spread."""
    model, dl0 = cut
    kw = dict(cr_method="aux_mala", cr_options=OPTS)
    mala = ASISGibbs(model, BINS, BLOCKS, [0.3 * d for d in dl0], **kw)
    over = ASISGibbs(model, BINS, BLOCKS, [0.3 * d for d in dl0],
                     cr_method="overrelax",
                     cr_options=flagship.CR_OPTIONS["overrelax"])
    gen = lambda: torch.Generator().manual_seed(7)
    a = flagship.start_state(mala, dl0, 4, gen())
    b = flagship.start_state(over, dl0, 4, gen())
    ref = mala.init_state(dl0, 4, gen())
    assert torch.equal(a.s, ref.s) and torch.equal(b.s, ref.s)
    for x, y in zip(b.dl, ref.dl):
        assert torch.equal(x, y)
    plain = over.init_state(dl0, 4, gen())
    sd = torch.sqrt(over.var_cls(plain.dl))
    assert float((plain.s - ref.s).abs().max()) > 0
    # the overrelaxed start's spread over the chains is ~10% of the aux_mala
    # start's (both in units of the prior's sd)
    spread = lambda s: float((s / torch.where(sd > 0, sd, 1.0)).std(0).mean())
    assert spread(plain.s) < 0.3 * spread(ref.s)


def test_tune_writes_only_its_own_record(tmp_path):
    """python -m gibbssampler_tpu_torch.tune at lmax 16 on the CPU (one
    segment of 2 iterations, 2 chains): it adds its record next to another
    key's, and a second run replaces its own."""
    path = tmp_path / "tp.json"
    other = dict(scheme="asis", grid="healpix", mask="band", lmax=16,
                 nbins=[15, 15], cr="aux_mala", sig=[[1.0] * 15] * 2)
    path.write_text(json.dumps({"records": [other]}))
    args = ["--grid", "gl", "--mask", "band", "--lmax", "16", "--device",
            "cpu", "--nchains", "2", "--seg-iters", "2", "--segments", "1",
            "--out", str(path), "--commit", "0" * 40]
    for _ in range(2):
        assert tune.main(args) == 0
    recs = json.loads(path.read_text())["records"]
    assert len(recs) == 2 and recs[0] == other
    rec = recs[1]
    assert (rec["grid"], rec["mask"], rec["cr"], rec["nbins"]) == (
        "gl", "band", "aux_mala", [15, 15])
    assert rec["card"] is None and rec["commit"] == "0" * 40
    assert len(rec["accept_per_block_per_segment"]) == 1
    assert len(rec["ms_per_iter_per_segment"]) == 1
