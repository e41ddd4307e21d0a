"""Process sharding, cross-chain collectives, proposal adaptation."""

from .adapt import (adapt_segments, analytic_proposal_sigma, block_widths,
                    pooled_proposal_sigmas, proposal_sigmas_from_results,
                    rescale_sigmas)
from .collectives import (acceptance_mean, ess_device, pooled_moments,
                          split_rhat_device)
from .sharding import (chain_seed, chain_sharding, gather_chains, m_rows,
                       make_mesh, shard_sht, sharded_run)

__all__ = ["make_mesh", "chain_sharding", "chain_seed", "shard_sht",
           "sharded_run", "gather_chains", "m_rows",
           "analytic_proposal_sigma", "pooled_proposal_sigmas",
           "block_widths", "proposal_sigmas_from_results", "rescale_sigmas",
           "adapt_segments",
           "pooled_moments", "split_rhat_device", "acceptance_mean",
           "ess_device"]
