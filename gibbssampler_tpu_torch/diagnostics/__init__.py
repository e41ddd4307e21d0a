"""Chain diagnostics and per-phase timing."""

from .mcmc import effective_sample_size, split_rhat, esjd, summarize_chains
from .timing import PhaseTimer, profile_trace, step_phase_times

__all__ = ["effective_sample_size", "split_rhat", "esjd", "summarize_chains",
           "PhaseTimer", "profile_trace", "step_phase_times"]
