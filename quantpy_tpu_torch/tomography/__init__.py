"""State and process tomography: the functional cores, the confidence
intervals and the user API."""

from .interval import (
    BootstrapProcessInterval,
    BootstrapStateInterval,
    HolderInterval,
    MHMCProcessInterval,
    MHMCStateInterval,
    MomentFidelityProcessInterval,
    MomentFidelityStateInterval,
    MomentInterval,
    PolytopeProcessInterval,
    PolytopeStateInterval,
    SugiyamaInterval,
)
from .process import ProcessTomograph
from .state import StateTomograph

__all__ = [
    "StateTomograph",
    "ProcessTomograph",
    "BootstrapStateInterval",
    "BootstrapProcessInterval",
    "MomentInterval",
    "MomentFidelityStateInterval",
    "MomentFidelityProcessInterval",
    "SugiyamaInterval",
    "PolytopeStateInterval",
    "PolytopeProcessInterval",
    "HolderInterval",
    "MHMCStateInterval",
    "MHMCProcessInterval",
]
