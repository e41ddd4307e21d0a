"""The package's spans and counters over a traced window, put down to the
layers of PERF.md section 3.

The program marks its layers itself (``gibbssampler_tpu_torch.diagnostics.
trace``): host spans named ``gs.<layer>.<what>``, recorded by
``torch.profiler`` on the clock of the CUDA activity, and the counters of
its host reads (``sync.<site>``).  ``record`` runs iterations of a cell's
timed path under the profiler with the program's tracing on and returns
the window's tables: the spans, every device op with the host time of the
runtime call that launched it (joined by CUPTI's correlation id, so the
kernels launched through ``ctypes``, which have no aten op, are joined
too), the synchronizing runtime calls and the counters.  ``attribute``
puts them down to the layers: busy device time to the span that launched
the work, idle device time to the span the host was in at the middle of
each gap.

    python3 -m cmbbench.spans --workload <cell> --seed <n>

sets the cell up as ``harness.execute`` does, then records three kinds of
window under the profiler: a traced window of ``TRACE_ITERS`` iterations,
the first profiler session of the process, whose attribution it prints;
``ON_COST_PAIRS`` pairs of windows of about ``ON_COST_SECONDS`` each,
without and with the program's tracing in the order untraced, traced,
traced, untraced, ... (the difference of the two medians is the
tracing's on-cost); and a last traced window, a later session of the
same process, attributed too, where a device-clock offset shows and
``attribute`` aligns it.  It prints one JSON line on standard output and
the busy and idle time by span on standard error.  It needs a CUDA
device.  (Until ``harness.execute`` records the second traced window
itself, this command is how the readings are taken.)
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cmbbench import harness  # noqa: E402
from cmbbench import inputs as inp  # noqa: E402
from cmbbench.roofline import LEGENDRE_KERNEL  # noqa: E402

__all__ = ["PREFIX", "SYNC_CALLS", "record", "tables", "attribute"]

# the program's span prefix (diagnostics.trace.PREFIX, restated so that
# this module reads traces without importing the program)
PREFIX = "gs."
MARKER = "cmbbench.spans_window"
# the least share of ops, %, that start after their launching call for a
# window's idle time to be put down to spans
CLOCK_MIN_PCT = 99.0
# the command's on-cost windows: pairs, and each window's length
ON_COST_PAIRS = 8
ON_COST_SECONDS = 4.0
# runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def _profiled(step, n_iter: int, device, traced: bool):
    """``step()`` ``n_iter`` times under ``torch.profiler`` (CPU, and CUDA
    on a card), with the program's tracing on when ``traced``; returns
    (window seconds by the host clock, the profiler, the counters)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from gibbssampler_tpu_torch.diagnostics import trace
    device = torch.device(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with (trace.tracing() if traced else contextlib.nullcontext()):
            with record_function(MARKER):
                t0 = time.perf_counter()
                for _ in range(n_iter):
                    step()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                window_s = time.perf_counter() - t0
        counts = trace.counters() if traced else {}
    return window_s, prof, counts


def record(step, n_iter: int, device):
    """``step()`` ``n_iter`` times under ``torch.profiler`` with the
    program's tracing on; returns (window seconds by the host clock,
    ``tables`` of the trace)."""
    window_s, prof, counts = _profiled(step, n_iter, device, True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return window_s, tables(events, counts)


def tables(events, counts=None) -> dict:
    """The tables of a Chrome-format trace (``traceEvents``): ``window``
    (start, end) us of the window's marker, ``spans`` [(name, args, start,
    end)] (the program's, prefix dropped), ``device_ops`` [(name, start,
    end, launch)] with ``launch`` the start of the runtime call of the same
    correlation id (None where there is none), ``runtime`` [(name, start,
    end)], ``counters``, and ``launch_in_host`` (launching calls that lie
    inside the host event that issued them, the device op's External id,
    of those checked): the runtime calls and the spans on one clock."""
    win, spans, dev, rt, corr, host = None, [], [], [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        args = e.get("args") or {}
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        if cat in ("cpu_op", "user_annotation") and "External id" in args:
            host.setdefault(args["External id"], []).append((s, end))
        if cat == "user_annotation":
            if name == MARKER:
                win = (s, end)
            elif name.startswith(PREFIX):
                base, _, sargs = name[len(PREFIX):].partition(" ")
                spans.append((base, sargs or None, s, end))
        elif cat in _DEVICE_CATS:
            dev.append((name, s, end, args.get("correlation"),
                        args.get("External id")))
        elif cat in _RUNTIME_CATS:
            rt.append((name, s, end))
            if args.get("correlation") is not None:
                corr[args["correlation"]] = (s, end)
    inside = checked = 0
    for *_, c, x in dev:
        call, hs = corr.get(c), host.get(x)
        if call and hs:
            checked += 1
            inside += any(a <= call[0] and call[1] <= b for a, b in hs)
    dev = [(n, s, e, corr[c][0] if c in corr else None)
           for n, s, e, c, _ in dev]
    return {"window": win, "spans": spans, "device_ops": dev,
            "runtime": rt, "counters": dict(counts or {}),
            "launch_in_host": (inside, checked)}


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

class _Timeline:
    """The innermost span at each instant, and each span's ancestors, of
    spans that nest (one host thread)."""

    def __init__(self, spans):
        self.spans = [sp for sp in spans if sp[3] > sp[2]]
        ev = []
        for i, (_, _, s, e) in enumerate(self.spans):
            ev.append((s, 1, -e, i))
            ev.append((e, 0, 0.0, i))
        ev.sort()
        self.parent = [-1] * len(self.spans)
        self.starts, self.owner = [], []
        stack = []
        for t, kind, _, i in ev:
            if kind:
                self.parent[i] = stack[-1] if stack else -1
                stack.append(i)
            else:
                stack.remove(i)
            self.starts.append(t)
            self.owner.append(stack[-1] if stack else -1)
        self._chain = {}

    def at(self, t: float) -> int:
        """The innermost span at ``t`` (-1: none)."""
        k = bisect.bisect_right(self.starts, t) - 1
        return self.owner[k] if k >= 0 else -1

    def chain(self, i: int) -> frozenset:
        """The names of span ``i`` and of its ancestors."""
        got = self._chain.get(i)
        if got is None:
            names, j = set(), i
            while j >= 0:
                names.add(self.spans[j][0])
                j = self.parent[j]
            got = self._chain[i] = frozenset(names)
        return got


def _gaps(dev_ops, win):
    """The idle gaps of the window: the window less the union of the
    device ops' intervals."""
    iv = sorted((max(s, win[0]), min(e, win[1])) for _, s, e, _ in dev_ops
                if e > win[0] and s < win[1])
    gaps, cur = [], win[0]
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if win[1] > cur:
        gaps.append((cur, win[1]))
    return gaps


def attribute(t: dict, n_iter: int) -> dict:
    """The layers' readings of a window's ``tables``, per iteration.

    ``metrics``: ``cr_busy_ms`` / ``cls_busy_ms`` (device time of the ops
    launched inside ``gibbs.cr`` / ``gibbs.cls``), ``cr_idle_ms`` /
    ``cls_idle_ms`` (idle time in gaps whose middle lies inside them),
    ``cut_ops_device_pct`` (device time of the ops whose innermost span is
    an ``op.*`` span, over all device time), ``sht_device_pct`` (ops under
    any ``sht.*`` span), ``host_syncs_per_iter`` (the ``sync.*`` counters
    over the iterations); a reading with nothing to read is left out.
    ``by_span``: busy and idle ms per iteration by innermost span name.
    ``checks``: what shows the spans and the device trace agree.

    No op starts before the runtime call that launched it, yet a profiler
    session can place the device's ops on the host clock milliseconds
    early (in some sessions, the first of a process as well as later
    ones).  Then a gap's middle is no instant of the host's: where fewer
    than ``CLOCK_MIN_PCT`` of the ops start after their launch
    (``clock_ok`` false), the idle readings are left out, and the window
    is to be recorded again."""
    win, spans, dev = t["window"], t["spans"], t["device_ops"]
    m = {}
    syncs = sum(v for k, v in t["counters"].items() if k.startswith("sync."))
    if spans:
        m["host_syncs_per_iter"] = syncs / n_iter
    out = {"metrics": m, "by_span": {}, "checks": {}}
    if not win or not spans:
        return out
    tl = _Timeline(spans)
    leads, early = [], {}
    for name, s, e, launch in dev:
        if launch is not None and win[0] <= launch <= win[1]:
            leads.append(s - launch)
            if s < launch:
                early[name[:60]] = early.get(name[:60], 0) + 1
    after_pct = (100.0 * sum(x >= 0 for x in leads) / len(leads)
                 if leads else None)
    clock_ok = after_pct is None or after_pct >= CLOCK_MIN_PCT
    dev = [op for op in dev if op[2] > win[0] and op[1] < win[1]]
    busy = {}
    total = cr = cls = cut = sht = charged = 0.0
    legendre_out = []
    for name, s, e, launch in dev:
        d = (min(e, win[1]) - max(s, win[0])) * 1e-3
        total += d
        i = tl.at(launch) if launch is not None else -1
        key = tl.spans[i][0] if i >= 0 else "(none)"
        busy[key] = busy.get(key, 0.0) + d
        if i < 0:
            if LEGENDRE_KERNEL.search(name):
                legendre_out.append(name)
            continue
        charged += d
        ch = tl.chain(i)
        cr += d * ("gibbs.cr" in ch)
        cls += d * ("gibbs.cls" in ch)
        cut += d * key.startswith("op.")
        sht += d * any(n.startswith("sht.") for n in ch)
        if LEGENDRE_KERNEL.search(name) and "sht.legendre" not in ch:
            legendre_out.append(name)
    idle = {}
    idle_tot = idle_in = cr_idle = cls_idle = 0.0
    for a, b in (_gaps(dev, win) if clock_ok else ()):
        d = (b - a) * 1e-3
        idle_tot += d
        i = tl.at(0.5 * (a + b))
        key = tl.spans[i][0] if i >= 0 else "(none)"
        idle[key] = idle.get(key, 0.0) + d
        if i >= 0:
            idle_in += d
            ch = tl.chain(i)
            cr_idle += d * ("gibbs.cr" in ch)
            cls_idle += d * ("gibbs.cls" in ch)
    if total > 0:
        m.update(cr_busy_ms=cr / n_iter, cls_busy_ms=cls / n_iter,
                 cut_ops_device_pct=100.0 * cut / total,
                 sht_device_pct=100.0 * sht / total)
        if clock_ok:
            m.update(cr_idle_ms=cr_idle / n_iter,
                     cls_idle_ms=cls_idle / n_iter)
    for k in set(busy) | set(idle):
        out["by_span"][k] = {"busy_ms": busy.get(k, 0.0) / n_iter,
                             "idle_ms": (idle.get(k, 0.0) / n_iter
                                         if clock_ok else None)}
    # the synchronizing runtime calls, by where the host was: inside a
    # sync.* span (a counted site), elsewhere in a program span (a site not
    # counted), or outside the program (the window's closing synchronize)
    where = {"counted": 0, "uncounted": {}, "outside": 0}
    for name, s, e in t["runtime"]:
        if not (win[0] <= s <= win[1]) or name not in SYNC_CALLS:
            continue
        i = tl.at(s)
        if i < 0:
            where["outside"] += 1
        elif any(n.startswith("sync.") for n in tl.chain(i)):
            where["counted"] += 1
        else:
            k = tl.spans[i][0]
            where["uncounted"][k] = where["uncounted"].get(k, 0) + 1
    dtoh = sum(1 for name, s, e, _ in dev if "DtoH" in name)
    # spans outside every iteration's gibbs.step: the variates' draws
    outside = {}
    for i, sp in enumerate(tl.spans):
        if not tl.chain(i) & {"gibbs.step", "gibbs.draw"}:
            outside[sp[0]] = outside.get(sp[0], 0) + 1
    out["checks"] = {
        "sync_calls_per_iter": (where["counted"]
                                + sum(where["uncounted"].values()))
        / n_iter,
        "sync_calls_uncounted": where["uncounted"],
        "sync_calls_outside": where["outside"],
        "dtoh_copies_per_iter": dtoh / n_iter,
        "legendre_outside_span": len(legendre_out),
        "device_charged_pct": 100.0 * charged / total if total else None,
        "idle_in_span_pct": 100.0 * idle_in / idle_tot if idle_tot else None,
        "launch_before_start_pct": after_pct,
        "clock_ok": clock_ok,
        # start less launch, us: least, 1st, 5th, 50th percentile
        "launch_lead_us": ([sorted(leads)[int(q * (len(leads) - 1))]
                            for q in (0.0, 0.01, 0.05, 0.5)]
                           if leads else None),
        "early_ops": dict(sorted(early.items(), key=lambda kv: -kv[1])[:5]),
        "launch_in_host_pct": (100.0 * t["launch_in_host"][0]
                               / t["launch_in_host"][1]
                               if t.get("launch_in_host", (0, 0))[1]
                               else None),
        "ops_joined_pct": (100.0 * sum(d[3] is not None for d in dev)
                           / len(dev) if dev else None),
        "busy_ms_per_iter": total / n_iter,
        "idle_ms_per_iter": idle_tot / n_iter if clock_ok else None,
        "spans": {k: sum(1 for sp in tl.spans if sp[0] == k)
                  for k in {sp[0] for sp in tl.spans}},
        "spans_outside_step": outside,
    }
    return out


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def _cell(root: Path, name: str, seed: int, device):
    """The cell's program and chains after set-up and burn-in, as
    ``harness.execute`` builds them: (program, state, variates'
    generator, chains)."""
    _, _, cell, cfg = harness.load_cell(root, name)
    var_seed, _ = harness._seeds(seed)
    nchains = int(cell["nchains"])
    pix = inp.pixelization(cfg)
    mask = inp.make_mask(cfg, pix)
    bl = inp.beam(cfg)
    gdata = torch.Generator(device=device).manual_seed(cfg["data_seed"])
    d, alm = inp.simulate(cfg, pix, mask, bl, gdata, device)
    dl0 = inp.start_dl(cfg, alm)
    prog = harness.Program(cfg, cell, pix, mask, bl, d, device)
    gen = torch.Generator(device=device).manual_seed(var_seed)
    state, _, _ = prog.start(dl0, alm, prog.draw(nchains, gen))
    for _ in range(int(cell["burn_in"])):
        state, _ = prog.step(state, prog.draw(nchains, gen))
    return prog, state, gen, nchains


def _spread(xs):
    """Quartile spread of ``xs`` over their median, %."""
    q = statistics.quantiles(xs, n=4)
    return 100.0 * (q[2] - q[0]) / statistics.median(xs)


def run(root: Path, name: str, seed: int, device="cuda", log=print) -> dict:
    """Cell ``name``'s windows (the module's docstring): the first traced
    window's attribution, the later one's under ``later_session``, every
    on-cost window's ms/iter and the on-cost."""
    device = torch.device(device)
    prog, state, gen, nchains = _cell(root, name, seed, device)
    box = [state]

    def step():
        box[0], _ = prog.step(box[0], prog.draw(nchains, gen))

    n_iter = harness.TRACE_ITERS
    w, first = record(step, n_iter, device)
    res = attribute(first, n_iter)
    res["counters"] = first["counters"]
    res["first_ms_per_iter"] = 1e3 * w / n_iter
    log(f"first traced window: {1e3 * w / n_iter:.3f} ms/iter")
    k = max(n_iter, round(ON_COST_SECONDS * n_iter / w))
    ms = {"untraced": [], "traced": []}
    for i in range(2 * ON_COST_PAIRS):
        traced = i % 4 in (1, 2)
        w, _, _ = _profiled(step, k, device, traced)
        kind = "traced" if traced else "untraced"
        ms[kind].append(1e3 * w / k)
        log(f"on-cost window ({kind}, {k} iterations): "
            f"{1e3 * w / k:.3f} ms/iter")
    _, last = record(step, n_iter, device)
    res["later_session"] = attribute(last, n_iter)
    lo = statistics.median(ms["untraced"])
    res.update(ms_per_iter=ms, on_cost_iters=k,
               spread_pct={kd: _spread(v) for kd, v in ms.items()},
               tracing_on_cost_pct=(100.0 * (statistics.median(ms["traced"])
                                             - lo) / lo))
    return res


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("cmbbench.spans: no CUDA device", file=sys.stderr)
        return 2
    os.environ["GIBBSSAMPLER_TORCH_TABLE_CACHE"] = "0"
    card = harness.card_info()
    tag = f"[{card['name']}, power limit {card['power_limit_w']} W]"
    log = lambda msg: print(f"cmbbench.spans {args.workload}: {msg} {tag}",
                            file=sys.stderr, flush=True)
    res = run(Path.cwd(), args.workload, args.seed, log=log)
    res.update(workload=args.workload, seed=args.seed, card=card)
    for which, r in (("first", res), ("later", res["later_session"])):
        for k, v in sorted(r["by_span"].items(),
                           key=lambda kv: -kv[1]["busy_ms"]
                           - (kv[1]["idle_ms"] or 0.0)):
            log(f"{which} session {k:28s} busy {v['busy_ms']:9.3f} ms  "
                f"idle {v['idle_ms']} ms per iteration")
        c = r["checks"]
        log(f"{which} session: launch before start "
            f"{c['launch_before_start_pct']}%, clock ok {c['clock_ok']}"
            f", device charged {c['device_charged_pct']}%, idle in span "
            f"{c['idle_in_span_pct']}%, metrics {r['metrics']}")
    log(f"tracing on-cost {res['tracing_on_cost_pct']:.3f}%, spread "
        f"{res['spread_pct']}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
