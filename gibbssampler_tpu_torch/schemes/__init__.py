"""Gibbs sampling schemes."""

from .gibbs import (GibbsState, GibbsScheme, CenteredGibbs, NonCenteredGibbs,
                    ASISGibbs, PNCPGibbs, CR_METHODS)

__all__ = ["GibbsState", "GibbsScheme", "CenteredGibbs", "NonCenteredGibbs",
           "ASISGibbs", "PNCPGibbs", "CR_METHODS"]
