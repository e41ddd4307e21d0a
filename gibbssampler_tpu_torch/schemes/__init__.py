"""Gibbs sampling schemes."""

from .gibbs import (GibbsState, GibbsScheme, CenteredGibbs, ASISGibbs,
                    CR_METHODS)

__all__ = ["GibbsState", "GibbsScheme", "CenteredGibbs", "ASISGibbs",
           "CR_METHODS"]
