"""Conditional samplers: constrained realizations and the C_ell step."""

from .cr import (noise_pool_spec, CRInfo, exact_cr, cg_cr, rjpo_cr,
                 aux_gibbs_cr, overrelax_cr, mala_cr, mala_log_ratio,
                 aux_then_mala_cr, pcn_cr, pcn_log_ratio, fluctuated_rhs,
                 cr_precond)
from .cls_samplers import (standard_gamma, invgamma_dl, centered_cls_sample,
                           invwishart_cls_sample,
                           propose_truncnorm, truncnorm_logratio, NCClsInfo,
                           NCLogLike, make_nc_log_likelihood, nc_cls_sample,
                           CutMHPlan,
                           nc_cls_sample_cut, whiten, recenter)
from .joint import (expand_cl_blocks, blocks_to_dl, exact_joint_cr,
                    joint_block_ops, cg_joint_cr, synfast_joint)

__all__ = ["noise_pool_spec", "CRInfo", "exact_cr", "cg_cr", "rjpo_cr",
           "aux_gibbs_cr", "overrelax_cr", "mala_cr", "mala_log_ratio",
           "aux_then_mala_cr", "pcn_cr", "pcn_log_ratio", "fluctuated_rhs",
           "cr_precond", "standard_gamma", "invgamma_dl",
           "centered_cls_sample", "propose_truncnorm", "truncnorm_logratio",
           "NCClsInfo", "NCLogLike", "make_nc_log_likelihood",
           "nc_cls_sample", "CutMHPlan", "nc_cls_sample_cut", "whiten",
           "recenter", "invwishart_cls_sample", "expand_cl_blocks",
           "blocks_to_dl", "exact_joint_cr", "joint_block_ops", "cg_joint_cr",
           "synfast_joint"]
