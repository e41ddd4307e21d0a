"""Linear operators: noise and the forward model."""

from .noise import NoiseModel
from .model import (SkyModel, cut_weights, healpix_belt_rows,
                    healpix_cut_weights, with_cut_decomposition)

__all__ = ["NoiseModel", "SkyModel", "cut_weights", "healpix_belt_rows",
           "healpix_cut_weights", "with_cut_decomposition"]
