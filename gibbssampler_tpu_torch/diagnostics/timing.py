"""Per-phase timing and profiling (PyTorch counterpart of
``gibbssampler_tpu.diagnostics.timing``).

Work on a CUDA device is asynchronous, so every timer here is fenced: it
waits for the device (``torch.cuda.synchronize``) before it reads the
clock.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from .trace import tracing

__all__ = ["PhaseTimer", "profile_trace", "step_phase_times"]


def _fence(x) -> None:
    """Wait for the CUDA device of every tensor in ``x`` (a tensor or a
    nested tuple / list / dict of them); nothing for CPU tensors."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _fence(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _fence(v)


@dataclass
class PhaseTimer:
    """Accumulates fenced wall-clock seconds per named phase.

    with timer("cr_step", block_on=out):   # out: what the phase computed
        ...
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    history: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        _fence(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        self.history.setdefault(name, []).append(dt)

    def summary(self) -> dict:
        return {
            name: {"total_s": tot, "count": self.counts[name],
                   "mean_ms": 1e3 * tot / self.counts[name]}
            for name, tot in self.totals.items()
        }


@contextlib.contextmanager
def _replayed(scheme, name: str, value):
    """The scheme with its method ``name`` answering ``value`` to every
    call, then as it was (an instance attribute put back, a class method
    uncovered again)."""
    own = vars(scheme)
    had, old = name in own, own.get(name)
    setattr(scheme, name, lambda *args, **kw: value)
    try:
        yield
    finally:
        if had:
            setattr(scheme, name, old)
        else:
            delattr(scheme, name)


def step_phase_times(scheme, state, gen: torch.Generator, reps: int = 3):
    """Fenced seconds of the Gibbs sub-steps at ``state``: (a) the CR step
    alone, (b) the C_ell step alone (``cls``: the iteration with its CR
    step replaced by a CR draw made once at ``state``, so that everything
    after the CR step runs on a real draw and nothing of the CR step runs)
    and (c) the whole iteration over the chain batch, each the least of
    ``reps`` calls, taken in turns (cr, cls, full, cr, ...) after one warm
    call of each, every call fenced on its own.  The least, not the mean:
    a stall of the host or a neighbour on the card lengthens single calls.
    The C_ell step is timed in calls of its own, not as ``full - cr``: at
    a ~2 ms C_ell step beside a ~13 ms CR step (lmax 512), host noise
    zeroed that difference.  The JAX package takes the mean of each and
    ``cls = max(full - cr, 0)``.

    The results are discarded: ``state`` and the scheme are left as they
    were.  Every draw comes from ``gen``, which the caller keeps apart from
    the chains' generator, so the chains do not depend on whether they
    were timed."""
    if hasattr(state, "cl"):
        method = "_cr"

        def cr():
            return scheme._cr(state.cl, gen=gen)
    else:
        method = "_cr_step"

        def cr():
            return scheme._cr_step(state.s, scheme.var_cls(state.dl),
                                   gen=gen)

    def full():
        return scheme.step(state, gen=gen)[0]

    drawn = cr()
    _fence(drawn)

    def cls():
        with _replayed(scheme, method, drawn):
            return scheme.step(state, gen=gen)[0]

    fns = {"cr": lambda: cr()[0], "cls": cls, "full": full}
    times = {name: [] for name in fns}
    for fn in fns.values():
        _fence(fn())
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            _fence(fn())
            times[name].append(time.perf_counter() - t0)
    return {name: min(t) for name, t in times.items()}


@contextlib.contextmanager
def profile_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card
    is present), written to ``logdir`` for TensorBoard / Perfetto, with the
    package's spans on (``trace.tracing``: ``gs.gibbs.step``, ``gs.gibbs.cr``,
    ``gs.op.*``, ``gs.sht.*``, ...); yields the profiler.  A profiler that
    fails to start raises."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof, tracing():
        yield prof
