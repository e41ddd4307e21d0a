"""Proposal adaptation for the blocked MH step (numpy only)."""

from .adapt import analytic_proposal_sigma, block_widths

__all__ = ["analytic_proposal_sigma", "block_widths"]
