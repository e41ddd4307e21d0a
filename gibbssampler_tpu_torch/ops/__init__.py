"""Linear operators: noise, the forward model, batched CG."""

from .noise import NoiseModel
from .model import (SkyModel, cut_weights, healpix_belt_rows,
                    healpix_cut_weights, with_cut_decomposition)
from .cg import cg_solve, CGInfo

__all__ = ["NoiseModel", "SkyModel", "cut_weights", "healpix_belt_rows",
           "healpix_cut_weights", "with_cut_decomposition", "cg_solve",
           "CGInfo"]
