"""Spans and counters inside the package, on the profiler's clock.

Off unless a ``tracing()`` block is open (``profile_trace`` opens one).
While it is, each ``span`` is a ``torch.profiler.record_function`` named
``PREFIX + name``, followed by a space and the span's args when it has
some (a profiler's trace keeps a record function's name, not its string
argument): under a running ``torch.profiler`` the span lands on the
host timeline that Kineto records on the same clock as the CUDA activity,
so each kernel (through the runtime call that launched it) and each idle
gap of the device can be put down to the span the host was in.  Spans and
counters stay in memory: the profiler that is running is their only
exporter (no NVTX, no file).

When tracing is off, ``span`` returns one shared no-op context after one
test of a module global and ``count`` returns at once: nothing is
formatted, allocated or synchronized (a span's ``args`` may be a callable,
called only when tracing is on).

The names, by layer (PERF.md section 3):

- scheme loop: ``gibbs.step`` around each ``step`` of every scheme (its
  args ``step=<i>``, the scheme's step index, which every span of that
  iteration sits under), ``gibbs.draw`` around ``draw_noise_pool``;
- CR step: ``gibbs.cr``, inside it the CR method's own span (``cr.aux``,
  ``cr.mala``, ``cr.exact``, ``cr.cg``, ``cr.rjpo``, ``cr.overrelax``,
  ``cr.pcn``);
- D_ell step: ``gibbs.cls`` (everything after the CR step), inside it
  ``cls.conjugate``, ``cls.gamma``, ``cls.whiten``, ``cls.mh`` (children
  ``mh.big`` and ``mh.singles``) and ``cls.recenter``;
- cut, hole and point operators: ``op.*``, the ``SkyModel`` operator;
- SHT: ``sht.pack`` (state <-> alm grids), ``sht.legendre`` (the Legendre
  stage; args kind, nr, C and table dtype), ``sht.rings`` (ring FFT / DFT
  and point evaluation);
- host reads of device values (each a synchronize on a card):
  ``sync.<site>``, a span and a counter of the same name
  (``host_bool``).
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["PREFIX", "span", "traced", "count", "host_bool", "counters",
           "tracing"]

# the prefix of every span name in a trace
PREFIX = "gs."

_on = False
_counts: dict = {}
_NOOP = contextlib.nullcontext()


def span(name: str, args=None):
    """A context: the span ``PREFIX + name`` while tracing is on, its
    ``args`` (a string, or a callable returning one) appended after a
    space; the shared no-op context otherwise."""
    if not _on:
        return _NOOP
    if callable(args):
        args = args()
    return torch.profiler.record_function(
        PREFIX + name if args is None else f"{PREFIX}{name} {args}")


def traced(name: str, args=None):
    """Decorator: each call of the function inside ``span(name)``;
    ``args``, when given, is called with the function's arguments (only
    while tracing is on) and returns the span's arguments."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            if not _on:
                return fn(*a, **k)
            with span(name, None if args is None else args(*a, **k)):
                return fn(*a, **k)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def host_bool(site: str, t: torch.Tensor) -> bool:
    """``bool(t)``, a host read of a device value: while tracing is on,
    inside span ``sync.<site>`` and counted by counter ``sync.<site>``."""
    if not _on:
        return bool(t)
    count("sync." + site)
    with span("sync." + site):
        return bool(t)


def counters() -> dict:
    """A snapshot of the counters: {name: count} since the last
    ``tracing()`` opened."""
    return dict(_counts)


@contextlib.contextmanager
def tracing():
    """Spans and counters on for the block, the counters reset on entry
    (they keep their values after it, for ``counters``)."""
    global _on
    was = _on
    _counts.clear()
    _on = True
    try:
        yield
    finally:
        _on = was
