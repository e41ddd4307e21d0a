"""Gibbs sampling schemes."""

from .gibbs import GibbsState, GibbsScheme, CenteredGibbs, CR_METHODS

__all__ = ["GibbsState", "GibbsScheme", "CenteredGibbs", "CR_METHODS"]
