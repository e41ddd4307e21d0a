"""Proposal adaptation for the blocked MH step."""

from .adapt import (adapt_segments, analytic_proposal_sigma, block_widths,
                    pooled_proposal_sigmas, proposal_sigmas_from_results,
                    rescale_sigmas)

__all__ = ["analytic_proposal_sigma", "pooled_proposal_sigmas",
           "block_widths", "proposal_sigmas_from_results", "rescale_sigmas",
           "adapt_segments"]
