"""The port's spans and counters (``diagnostics.trace``): off, they are one
shared no-op and leave every result bit for bit as it was; on, under
``torch.profiler``, one iteration of a tiny cut-sky float64 ASIS or
centered scheme emits the documented spans, nested by layer, each
iteration's under a ``gibbs.step`` that names its step index; the host
reads are counted where they happen; ``profile_trace`` writes the spans
into its trace."""

import json
import gzip
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gibbssampler_tpu_torch.diagnostics import (count, counters,
                                                profile_trace, span, trace,
                                                tracing)
from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.ops.cg import cg_solve
from gibbssampler_tpu_torch.samplers.cls_samplers import standard_gamma
from gibbssampler_tpu_torch.schemes import ASISGibbs, CenteredGibbs

LMAX = 12
NCH = 3
OPTS = {"n_gibbs": 1, "tau": 0.02}
BINS = [np.arange(2, LMAX + 2), np.array([2, 3, 4, 5, 6, 7, 8, 10, 11, 13])]
BLOCKS = [[(0, 11)], [(0, 3)] + [(i, i + 1) for i in range(3, 9)]]
# the spans one iteration emits, by scheme
SPANS = {"gibbs.step", "gibbs.cr", "cr.aux", "cr.mala", "gibbs.cls",
         "cls.conjugate", "op.synthesis_cut", "op.adjoint_cut",
         "op.synthesis_cut_sp", "op.adjoint_cut_sp", "op.loglike_cut_delta",
         "sht.pack", "sht.legendre", "sht.rings"}
ASIS_SPANS = {"cls.whiten", "cls.mh", "mh.big", "mh.singles", "cls.recenter",
              "op.loglike_cut"}


@pytest.fixture(scope="module")
def model():
    gen = torch.Generator().manual_seed(0)
    nr = LMAX + 1
    theta = np.arccos(np.polynomial.legendre.leggauss(nr)[0][::-1])
    keep = (np.abs(np.pi / 2 - theta) > 0.2).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (nr, 2 * LMAX + 2))
    dls = np.stack([example_dl(LMAX, "ee"), example_dl(LMAX, "bb")])
    m, _ = simulate_dataset(LMAX, 2, dls, 0.2 ** 2,
                            fwhm_radians=np.radians(0.5), mask=mask,
                            dtype=torch.float64, device="cpu", gen=gen)
    dl0 = [np.array([d[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])])
           for d, b in zip(dls, BINS)]
    return with_cut_decomposition(m), dl0


def _scheme(model, kind):
    m, dl0 = model
    if kind == "asis":
        sch = ASISGibbs(m, BINS, BLOCKS, [0.2 * d for d in dl0],
                        cr_method="aux_mala", cr_options=OPTS)
    else:
        sch = CenteredGibbs(m, BINS, cr_method="aux_mala", cr_options=OPTS)
    return sch, sch.init_state(dl0, NCH, torch.Generator().manual_seed(1))


def _step(sch, state, seed=2):
    """One iteration from a fresh generator: (state, info)."""
    gen = torch.Generator().manual_seed(seed)
    return sch.step(state, noise=sch.draw_noise_pool(NCH, gen), gen=gen)


def _spans(prof):
    """[(name, args, start, end, parent name)] of the package's spans,
    the parent being the innermost enclosing package span."""
    out = []
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            base, _, args = e.name[len(trace.PREFIX):].partition(" ")
            out.append((base, args, e.time_range.start, e.time_range.end))
    res = []
    for i, (n, a, s, t) in enumerate(out):
        enc = [o for j, o in enumerate(out) if j != i and o[2] <= s
               and t <= o[3] and (o[2], -o[3]) < (s, -t)]
        parent = max(enc, key=lambda o: (o[2], -o[3]))[0] if enc else None
        res.append((n, a, s, t, parent))
    return res


def test_off_is_one_noop():
    """Off: every span is the one shared no-op context, a callable args is
    not called, counters stay empty; ``tracing`` resets them and turns
    everything off again on exit."""
    def boom():
        raise AssertionError("args formatted while tracing is off")
    assert span("gibbs.step") is span("op.x", boom) is trace._NOOP
    count("sync.x")
    assert trace.host_bool("x", torch.tensor(True)) is True
    assert counters() == {}
    with tracing():
        count("sync.x", 2)
        assert counters() == {"sync.x": 2}
        assert span("gibbs.step") is not trace._NOOP
    assert counters() == {"sync.x": 2}
    assert span("gibbs.step") is trace._NOOP
    with tracing():
        assert counters() == {}


@pytest.mark.parametrize("kind", ["asis", "centered"])
def test_tracing_changes_no_result(model, kind):
    """One step with tracing off and on, from the same state and variates:
    bit-identical state, D_ell and accepts; off, no counter moves."""
    sch, st = _scheme(model, kind)
    before = counters()
    off, info_off = _step(sch, st)
    assert counters() == before
    with profile(activities=[ProfilerActivity.CPU]), tracing():
        on, info_on = _step(sch, st)
    assert torch.equal(off.s, on.s)
    for a, b in zip(off.dl + info_off["dl"], on.dl + info_on["dl"]):
        assert torch.equal(a, b)
    assert torch.equal(info_off["cr_accept"], info_on["cr_accept"])
    if kind == "asis":
        for a, b in zip(info_off["mh_accept"], info_on["mh_accept"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["asis", "centered"])
def test_spans_nest_by_layer(model, kind):
    """Two steps under the profiler: every documented span, gibbs.cr and
    gibbs.cls under gibbs.step (args: the scheme's step index, 0 and 1
    after the first two steps' indices), the CR methods under gibbs.cr,
    the gamma draw (drawn here, not injected) and its host reads under the
    conjugate draw, mh.* under cls.mh, each sht.* under an op.* span,
    another sht.* span or the MH engine (which calls the transforms'
    stages itself), and every span but the draws' inside a step."""
    sch, st = _scheme(model, kind)
    base = sch.nsteps
    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing():
        st, _ = _step(sch, st)
        _step(sch, st, seed=3)
    sp = _spans(prof)
    names = {s[0] for s in sp}
    assert SPANS | (ASIS_SPANS if kind == "asis" else set()) <= names
    if kind == "centered":
        assert not {"cls.mh", "mh.big", "mh.singles"} & names
    steps = [s for s in sp if s[0] == "gibbs.step"]
    assert [s[1] for s in steps] == [f"step={base}", f"step={base + 1}"]
    assert all(s[4] is None for s in steps)
    for n, a, s, t, parent in sp:
        if n in ("gibbs.cr", "gibbs.cls"):
            assert parent == "gibbs.step", n
        elif n.startswith("cr."):
            assert parent == "gibbs.cr", n
        elif n == "cls.gamma":
            assert parent == "cls.conjugate"
        elif n.startswith("cls."):
            assert parent == "gibbs.cls", n
        elif n.startswith("sync.gamma."):
            assert parent == "cls.gamma", n
        elif n.startswith("mh."):
            assert parent == "cls.mh", n
        elif n.startswith("sht."):
            assert parent.startswith(("op.", "sht.", "cls.mh", "mh.")), \
                (n, parent)
        if n != "gibbs.step" and n != "gibbs.draw":
            assert any(x[0] == "gibbs.step" and x[2] <= s and t <= x[3]
                       for x in steps), n
    leg = [a for n, a, *_ in sp if n == "sht.legendre"]
    assert leg and all(a.startswith(("kind=synth nr=", "kind=adj nr="))
                       and " C=" in a and a.endswith("table=float64")
                       for a in leg)


def _bools(monkeypatch):
    """A list that grows by one at every ``Tensor.__bool__``."""
    seen = []
    orig = torch.Tensor.__bool__

    def wrapped(self):
        seen.append(1)
        return orig(self)
    monkeypatch.setattr(torch.Tensor, "__bool__", wrapped)
    return seen


@pytest.mark.parametrize("site", ["gamma", "cg"])
def test_sync_counters_count_host_reads(monkeypatch, site):
    """The sync.* counters of standard_gamma (its alpha check and one per
    rejection round) and of cg_solve (one per iteration) equal the host
    reads counted by wrapping ``torch.Tensor.__bool__`` during the call."""
    gen = torch.Generator().manual_seed(4)
    alpha = torch.full((5, 40), 1.5, dtype=torch.float64)
    diag = torch.rand((4, 2, 30), generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn((4, 2, 30), generator=gen, dtype=torch.float64)
    with tracing():
        seen = _bools(monkeypatch)
        if site == "gamma":
            standard_gamma(alpha, gen)
        else:
            cg_solve(lambda x: diag * x + 0.1 * x.flip(-1), b, tol=1e-10)
        monkeypatch.undo()
        got = counters()
    assert all(k.startswith("sync.") for k in got)
    assert sum(got.values()) == len(seen) >= 2
    if site == "gamma":
        assert got["sync.gamma.alpha"] == 1
    else:
        assert got["sync.cg.iter"] >= 2


def test_profile_trace_writes_spans(model, tmp_path):
    """``profile_trace`` turns the spans on for its block: the trace it
    writes holds each step's gibbs.step and the layers under it."""
    sch, st = _scheme(model, "centered")
    with profile_trace(tmp_path):
        _step(sch, st)
    files = list(Path(tmp_path).glob("*.json*"))
    assert len(files) == 1
    opener = gzip.open if files[0].suffix == ".gz" else open
    with opener(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "").partition(" ")[0] for e in events}
    assert {"gs.gibbs.step", "gs.gibbs.cr", "gs.cr.aux", "gs.cls.conjugate",
            "gs.op.synthesis_cut", "gs.sht.legendre"} <= names
    assert span("gibbs.step") is trace._NOOP
