"""Linear operators: noise and the forward model."""

from .noise import NoiseModel
from .model import SkyModel, with_cut_decomposition

__all__ = ["NoiseModel", "SkyModel", "with_cut_decomposition"]
