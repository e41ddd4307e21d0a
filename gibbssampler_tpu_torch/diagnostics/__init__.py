"""Chain diagnostics."""

from .mcmc import effective_sample_size, split_rhat, esjd, summarize_chains

__all__ = ["effective_sample_size", "split_rhat", "esjd", "summarize_chains"]
