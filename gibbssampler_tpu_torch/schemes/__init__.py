"""Gibbs sampling schemes."""

from .gibbs import (GibbsState, GibbsScheme, CenteredGibbs, NonCenteredGibbs,
                    ASISGibbs, PNCPGibbs, CR_METHODS)
from .joint_scheme import JointState, JointCenteredGibbs

__all__ = ["GibbsState", "GibbsScheme", "CenteredGibbs", "NonCenteredGibbs",
           "ASISGibbs", "PNCPGibbs", "CR_METHODS", "JointState",
           "JointCenteredGibbs"]
