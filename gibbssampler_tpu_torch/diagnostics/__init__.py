"""Chain diagnostics, per-phase timing, and the spans and counters of
the package's traces."""

from .mcmc import effective_sample_size, split_rhat, esjd, summarize_chains
from .timing import PhaseTimer, profile_trace, step_phase_times
from .trace import count, counters, span, tracing

__all__ = ["effective_sample_size", "split_rhat", "esjd", "summarize_chains",
           "PhaseTimer", "profile_trace", "step_phase_times", "span", "count",
           "counters", "tracing"]
