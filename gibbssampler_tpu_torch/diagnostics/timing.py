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


def step_phase_times(scheme, state, gen: torch.Generator, reps: int = 3):
    """Fenced seconds of the Gibbs sub-steps at ``state``: (a) the CR step
    alone and (b) the whole iteration over the chain batch, each the least
    of ``reps`` calls, taken in turns (cr, full, cr, full, ...) after one
    warm call of each, every call fenced on its own; the C_ell step's
    share is ``cls = max(full - cr, 0)``.  The least, not the mean: a
    stall of the host or a neighbour on the card lengthens single calls,
    and the difference of two means would carry it into ``cls``.

    The results are discarded: ``state`` and the scheme are left as they
    were.  Every draw comes from ``gen``, which the caller keeps apart from
    the chains' generator, so the chains do not depend on whether they
    were timed."""
    if hasattr(state, "cl"):
        def cr():
            return scheme._cr(state.cl, gen=gen)[0]
    else:
        def cr():
            return scheme._cr_step(state.s, scheme.var_cls(state.dl),
                                   gen=gen)[0]

    def full():
        return scheme.step(state, gen=gen)[0]

    fns = {"cr": cr, "full": full}
    times = {name: [] for name in fns}
    for name, fn in fns.items():
        _fence(fn())
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            _fence(fn())
            times[name].append(time.perf_counter() - t0)
    out = {name: min(t) for name, t in times.items()}
    out["cls"] = max(out["full"] - out["cr"], 0.0)
    return out


@contextlib.contextmanager
def profile_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card
    is present), written to ``logdir`` for TensorBoard / Perfetto; yields
    the profiler.  A profiler that fails to start raises."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof
