"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell needs is found by name: the cell's file
``workloads/<cell>.json`` (its configuration, scheme, CR method and
options, chains, burn-in, limits), the configuration's file
``configs/<config>.json`` (sizes, mask, noise, beam, bins, blocks, proposal
scales), and one reader per metric, ``metrics/<metric>.py``, for the
metrics that ``BENCHMARK.json`` lists for the cell.

The system under test is ``gibbssampler_tpu_torch`` (imported inside the
functions that build it): its sky model, cut decomposition and Gibbs
scheme, built from the benchmark's own inputs.  The window drives the
scheme's iteration, ``scheme.step``, with every random variate drawn by
the benchmark from its generator on the device and handed in (the noise
pool through the scheme's own ``draw_noise_pool``, the gamma variates
through the package's ``standard_gamma``, as ``scheme.run`` draws them), so
that the reference can be handed the same variates afterwards.
"""

from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import ess as ess_mod
from . import inputs as inp
from .reference import check as check_mod
from .reference.posterior import Posterior, StructureMismatch

__all__ = ["PKG", "load_cell", "cell_metrics", "execute", "card_info"]

PKG = Path(__file__).resolve().parent
# iterations of the traced window, and the window iteration checked
# besides the start: one drawn from the seed among the first CHECK_SPAN
TRACE_ITERS = 8
CHECK_SPAN = 8
_FORBIDDEN = ("jax", "jaxlib", "flax", "gibbssampler_tpu")


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str):
    """(BENCHMARK.json, its entry for cell ``name``, the cell's file, the
    configuration's file)."""
    bench = _read(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = _read(PKG / "workloads" / f"{name}.json")
    if cell["config"] != entry["config"]:
        raise ValueError(f"{name}: cell file names configuration "
                         f"{cell['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    cfg = _read(PKG / "configs" / f"{entry['config']}.json")
    return bench, entry, cell, cfg


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The metrics of section ``kind`` ("end_to_end" or "per_layer") that
    cell ``name`` reports: those without a "workloads" key, and those
    whose list holds it."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def card_info() -> dict:
    """The card's name and power limit (nvidia-smi), beside every reading."""
    info = {"name": torch.cuda.get_device_name(0)
            if torch.cuda.is_available() else "cpu",
            "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def _seeds(seed: int):
    """(the variates' generator seed, numpy generator of the checked step)
    of a run's ``--seed``."""
    a, b = np.random.SeedSequence(int(seed)).spawn(2)
    return (int(a.generate_state(1, np.uint64)[0] >> np.uint64(1)),
            np.random.default_rng(b))


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

class Program:
    """The measured package's scheme on the benchmark's dataset."""

    def __init__(self, cfg, cell, pix, mask, bl, d, device):
        from gibbssampler_tpu_torch.flagship import flagship_sht
        from gibbssampler_tpu_torch.ops import (NoiseModel, SkyModel,
                                                with_cut_decomposition)
        from gibbssampler_tpu_torch.samplers import cls_samplers
        from gibbssampler_tpu_torch.samplers import cr as cr_mod
        from gibbssampler_tpu_torch.schemes import ASISGibbs, CenteredGibbs
        self._cls, self._cr = cls_samplers, cr_mod
        dt = getattr(torch, cfg["dtype"])
        self.dtype, self.device = dt, torch.device(device)
        lmax = cfg["lmax"]
        grid = cfg["grid"]["kind"]
        sht = flagship_sht(grid, lmax, device, dt)
        d32 = torch.as_tensor(d, device=self.device).to(dt)
        if grid == "healpix":
            noise = NoiseModel.white_healpix(cfg["sigma2"], sht.geo, 2,
                                             mask=mask, dtype=dt, sht=sht,
                                             device=device)
            d_prog = sht.from_ring(d32)
        else:
            if not np.allclose(sht.grid.theta, pix.theta, rtol=0,
                               atol=1e-12):
                raise ValueError("the program's grid rings differ from the "
                                 "benchmark's")
            shape = (pix.theta.size, int(pix.nphi[0]))
            noise = NoiseModel.white(cfg["sigma2"], sht.grid, 2,
                                     mask=mask.reshape(shape), dtype=dt,
                                     device=device)
            d_prog = d32.reshape((2,) + shape)
        model = SkyModel(sht=sht, noise=noise, spin=2, d=d_prog,
                         bl=torch.as_tensor(bl, dtype=dt, device=device))
        self.model = with_cut_decomposition(model)
        bins = [np.asarray(b) for b in cfg["bins"]]
        opts = dict(cell["cr_options"])
        self.kind = cell["scheme"]
        if self.kind == "asis":
            self.scheme = ASISGibbs(self.model, bins, cfg["blocks"],
                                    cfg["prop_sigma"], n_iter_mh=1,
                                    cr_method=cell["cr"], cr_options=opts)
            self.nblocks = sum(len(b) for b in cfg["blocks"])
        elif self.kind == "centered":
            self.scheme = CenteredGibbs(self.model, bins,
                                        cr_method=cell["cr"],
                                        cr_options=opts)
            self.nblocks = 0
        else:
            raise ValueError(f"scheme {self.kind!r}; asis or centered")
        if cell["cr"] != "aux_mala":
            raise ValueError("the benchmark's CR step is aux_mala")
        self.tau = float(opts["tau"])
        self.n_gibbs = int(opts["n_gibbs"])
        self.nbins = sum(len(b) - 1 for b in bins)
        self.alphas = [torch.as_tensor(inp.gamma_alpha(b), dtype=dt,
                                       device=device) for b in bins]

    def draw(self, n: int, gen: torch.Generator) -> dict:
        """One iteration's variates, from ``gen`` in a fixed order."""
        kw = dict(generator=gen, dtype=self.dtype, device=self.device)
        v = {"pool": self.scheme.draw_noise_pool(n, gen),
             "u": torch.rand((n,), **kw),
             "gammas": tuple(self._cls.standard_gamma(
                 a.expand(n, -1), gen) for a in self.alphas)}
        if self.nblocks:
            v["u_prop"] = torch.rand((n, 1, self.nbins), **kw)
            v["u_acc"] = torch.rand((n, 1, self.nblocks), **kw)
        return v

    def start(self, dl0, s_sky, v):
        """The chains' start: one CR draw at ``dl0`` from the simulated sky's
        own state ``s_sky`` (2, nstate)."""
        from gibbssampler_tpu_torch.schemes.gibbs import GibbsState
        n = v["u"].shape[0]
        dl = tuple(torch.as_tensor(x, dtype=self.dtype, device=self.device)
                   .expand(n, -1).clone() for x in dl0)
        s0 = s_sky.to(self.device, self.dtype).expand(n, -1, -1).clone()
        s, info = self._cr.aux_then_mala_cr(
            self.model, self.scheme.var_cls(dl), self.scheme.bt_ninv_d, s0,
            n_gibbs=self.n_gibbs, tau=self.tau, noise=v["pool"], u=v["u"])
        return GibbsState(s=s, dl=dl), info.accept, s0

    def step(self, state, v):
        kw = dict(noise=v["pool"], u=v["u"], gammas=v["gammas"])
        if self.nblocks:
            kw.update(u_prop=v["u_prop"], u_acc=v["u_acc"])
        return self.scheme.step(state, **kw)

    def aux_geometry(self) -> dict:
        """The positions of the scheme's auxiliary pixel fields, as the
        package declares them (its cut rings, its hole points)."""
        g = self.model.cut_sht.grid
        sp = self.model.sp_sht
        return {"cut": (np.asarray(g.theta), int(g.nphi),
                        np.asarray(g.phi0)),
                "sp": None if sp is None else (
                    np.asarray(sp.theta), np.asarray(sp.phi),
                    sp.valid.detach().cpu().numpy())}


# ---------------------------------------------------------------------------
# tracing helpers
# ---------------------------------------------------------------------------

class LegendreCalls:
    """Records every call of the Legendre stage (``LegendreCore.
    _lsynth_stack`` / ``_ladj_stack``) while active: kind, L, rings,
    columns, table and compute dtype, and whether the ring set is
    symmetric about the equator."""

    def __init__(self):
        from gibbssampler_tpu_torch.sht import lcore
        self.core = lcore.LegendreCore
        self.calls = []
        self._orig = {}

    def _theta(self, obj):
        grid = getattr(obj, "grid", None)
        th = grid.theta if grid is not None else getattr(obj, "theta", None)
        return None if th is None else np.asarray(th, np.float64)

    def __enter__(self):
        from .reference.sphere import symmetric_rings
        calls = self.calls

        def wrap(name, kind):
            orig = getattr(self.core, name)
            self._orig[name] = orig

            def inner(obj, lam, g, *a, **k):
                out = orig(obj, lam, g, *a, **k)
                th = self._theta(obj)
                src = out if kind == "synth" else g
                calls.append({
                    "kind": kind, "L": obj.lmax + 1, "nr": int(src.shape[-2]),
                    "C": int(np.prod(src.shape[:-2])),
                    "table": str(lam.dtype).replace("torch.", ""),
                    "compute": str(obj.dtype).replace("torch.", ""),
                    "symmetric": None if th is None else symmetric_rings(th)})
                return out
            setattr(self.core, name, inner)

        wrap("_lsynth_stack", "synth")
        wrap("_ladj_stack", "adj")
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.core, name, fn)
        return False


def _trace_tables(prof, marker: str):
    """(window (start, end) us, device ops [(name, start, end)], host ops
    [(name, start, end)]) of a finished profiler.  User annotations
    (``record_function`` spans, which the profiler also marks on the
    device's timeline) are spans, not device work, and are left out."""
    from torch.autograd import DeviceType
    win, dev, host, notes = None, [], [], {marker}
    events = prof.events()
    for e in events:
        if getattr(e, "is_user_annotation", False):
            notes.add(e.name)
    for e in events:
        tr = e.time_range
        if e.name == marker and e.device_type != DeviceType.CUDA:
            win = (tr.start, tr.end)
        elif e.name in notes:
            continue
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    return win, dev, host


def _busy(dev_ops, win):
    """Merged busy intervals of the device ops inside ``win`` (us)."""
    iv = sorted((max(s, win[0]), min(e, win[1])) for _, s, e in dev_ops
                if e > win[0] and s < win[1])
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _breakdown(dev_ops, host_ops, win, merged):
    """The top device ops by time and the longest idle gaps, summed by the
    innermost host op that was running at each gap's middle."""
    tot = {}
    for name, s, e in dev_ops:
        if e > win[0] and s < win[1]:
            tot[name] = tot.get(name, 0.0) + (min(e, win[1])
                                              - max(s, win[0])) * 1e-6
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    edges = [win[0]] + [x for iv in merged for x in iv] + [win[1]]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    if host_ops:
        hn = np.array([h[0] for h in host_ops], dtype=object)
        hs = np.array([h[1] for h in host_ops], dtype=np.float64)
        he = np.array([h[2] for h in host_ops], dtype=np.float64)
    by = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        label = "(no host op)"
        if host_ops:
            mid = 0.5 * (a + b)
            sel = np.nonzero((hs <= mid) & (he >= mid))[0]
            if sel.size:
                label = str(hn[sel[np.argmin(he[sel] - hs[sel])]])
        by[label] = by.get(label, 0.0) + (b - a) * 1e-6
    idle = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stack_hist(hist):
    nf = len(hist[0][0])
    dl = [torch.stack([h[0][f] for h in hist], 1).float().cpu().numpy()
          for f in range(nf)]
    cr = torch.stack([h[1] for h in hist], 1).float().cpu().numpy()
    mh = (None if hist[0][2] is None else
          [torch.stack([h[2][f] for h in hist], 1).float().cpu().numpy()
           for f in range(nf)])
    return dl, cr, mh


def execute(root: Path, name: str, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: float | None = None, log=None,
            sabotage=None, card=None) -> dict:
    """One run of cell ``name``; returns the result object (the run's last
    line).  ``sabotage``: a test's hook that breaks what the timed path
    returns, (iteration, state in, state out, info) -> (state out, info)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: None)
    bench, entry, cell, cfg = load_cell(root, name)
    device = torch.device(device)
    log(f"harness loaded at {time.perf_counter() - t_start:.3f} s")
    var_seed, rng = _seeds(seed)
    nchains = int(cell["nchains"])

    # the benchmark's inputs
    pix = inp.pixelization(cfg)
    mask = inp.make_mask(cfg, pix)
    bl = inp.beam(cfg)
    # the dataset is the configuration's (its own seed), the same in every
    # run, so that seeds change the chains and not the posterior
    gdata = torch.Generator(device=device).manual_seed(cfg["data_seed"])
    d, alm = inp.simulate(cfg, pix, mask, bl, gdata, device)
    dl0 = inp.start_dl(cfg, alm)
    _sync(device)
    log(f"inputs made at {time.perf_counter() - t_start:.3f} s")

    # the system under test
    prog = Program(cfg, cell, pix, mask, bl, d, device)
    _sync(device)
    log(f"program built at {time.perf_counter() - t_start:.3f} s")
    gen = torch.Generator(device=device).manual_seed(var_seed)
    g_start = gen.get_state()
    v = prog.draw(nchains, gen)
    state, start_acc, s_sky = prog.start(dl0, alm, v)
    start_check = {"what": "start", "gen": g_start, "s_in": s_sky,
                   "dl_in": state.dl, "s_out": state.s, "dl_out": state.dl,
                   "cr_acc": start_acc}
    for _ in range(int(cell["burn_in"])):
        state, _ = prog.step(state, prog.draw(nchains, gen))
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({cell['burn_in']} burn-in iterations)")

    k1 = int(rng.integers(0, min(CHECK_SPAN, TRACE_ITERS)))
    hist, saved = [], {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def one(it, state):
        """One window iteration; the checked one keeps its generator state,
        its state in and its outputs."""
        gs = gen.get_state()
        new, info = prog.step(state, prog.draw(nchains, gen))
        if sabotage is not None:
            new, info = sabotage(it, state, new, info)
        hist.append((info["dl"], info["cr_accept"], info.get("mh_accept")))
        if it == k1:
            saved.update(gen=gs, s_in=state, s_out=new, info=info)
        return new

    t0 = time.perf_counter()
    if not trace:
        it = 0
        while it <= k1 or time.perf_counter() - t0 < seconds:
            state = one(it, state)
            it += 1
        _sync(device)
        window_s = time.perf_counter() - t0
    else:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with LegendreCalls() as legendre, profile(activities=acts) as prof:
            with record_function("cmbbench.window"):
                t0 = time.perf_counter()
                for it in range(TRACE_ITERS):
                    state = one(it, state)
                _sync(device)
                window_s = time.perf_counter() - t0
    n_iter = len(hist)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window {window_s:.3f} s, {n_iter} iterations, "
        f"{1e3 * window_s / n_iter:.3f} ms/iter, peak {peak} bytes")

    phase = None
    if trace:
        from gibbssampler_tpu_torch.diagnostics.timing import step_phase_times
        gt = torch.Generator(device=device).manual_seed(var_seed ^ 1)
        phase = step_phase_times(prog.scheme, state, gt, reps=3)

    # the checked steps' variates, drawn again from the saved generator
    # states; then the program's state is freed
    info = saved["info"]
    checks = [start_check, {
        "what": "iter", "gen": saved["gen"], "s_in": saved["s_in"].s,
        "dl_in": saved["s_in"].dl, "s_out": saved["s_out"].s,
        "dl_out": saved["s_out"].dl, "cr_acc": info["cr_accept"],
        "mh_acc": info.get("mh_accept")}]
    for c in checks:
        gen.set_state(c.pop("gen"))
        c["variates"] = prog.draw(nchains, gen)
    aux = prog.aux_geometry()
    kind = prog.kind
    dl_hist, cr_hist, mh_hist = _stack_hist(hist)
    del prog, state, saved, hist, v, info
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference
    t_ref = time.perf_counter()
    numbers, failed = _judge(cfg, cell, pix, mask, d, bl, aux, checks,
                             kind, device)
    log(f"reference check {time.perf_counter() - t_ref:.3f} s")
    limits = cell["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)

    ctx = {"cfg": cfg, "cell": cell, "setup_s": setup_s,
           "window_s": window_s, "n_iter": n_iter, "nchains": nchains,
           "dl_chains": dl_hist, "cr_accept": cr_hist, "mh_accept": mh_hist}
    card = card or card_info()
    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": card["name"], "count": 1,
                     "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        ess = [ess_mod.bin_ess(x) for x in dl_hist]
        ctx["ess"] = ess_mod.summary(ess, cfg["bins"][-1])
        wanted = cell_metrics(bench, name, "end_to_end")
    else:
        win, dev_ops, host_ops = _trace_tables(prof, "cmbbench.window")
        merged = _busy(dev_ops, win) if win else []
        busy = sum(e - s for s, e in merged) * 1e-6
        ctx.update(window_us=win, device_ops=dev_ops, busy_s=busy,
                   legendre_calls=legendre.calls, phase_s=phase)
        result_device["busy_s"] = busy
        result_device["window_s"] = (win[1] - win[0]) * 1e-6 if win else 0.0
        breakdown = _breakdown(dev_ops, host_ops, win, merged) if win \
            else {"device_ops": [], "idle_gaps": []}
        wanted = cell_metrics(bench, name, "per_layer")
    metrics = {}
    for m in wanted:
        reader = importlib.import_module(f"cmbbench.metrics.{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    res = {"correct": bool(correct), "attempted": n_iter * nchains,
           "failed": int(failed), "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["card"] = card
    res["checked"] = {k: {"value": numbers[k], "limit": limits[k]}
                      for k in limits}
    return res


def _judge(cfg, cell, pix, mask, d, bl, aux, checks, kind, device):
    """({number: largest value over the checked chains}, chain-steps that
    exceed a limit)."""
    limits = cell["limits"]
    try:
        post = Posterior(cfg, pix, mask, d, bl, aux, device)
    except StructureMismatch:
        return {k: float("inf") for k in limits}, len(checks)
    per = check_mod.judge(post, kind, checks, float(cell["cr_options"]["tau"]))
    numbers = {k: float(per[k].max()) for k in limits}
    bad = torch.zeros_like(per["state_err"], dtype=torch.bool)
    for k in limits:
        bad |= ~(per[k] <= limits[k])
    return numbers, int(bad.sum())


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in _FORBIDDEN})
