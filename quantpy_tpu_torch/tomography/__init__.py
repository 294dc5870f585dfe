"""State and process tomography: the functional cores, the bootstraps and
the user API."""

from .interval import BootstrapProcessInterval, BootstrapStateInterval
from .process import ProcessTomograph
from .state import StateTomograph

__all__ = [
    "StateTomograph",
    "ProcessTomograph",
    "BootstrapStateInterval",
    "BootstrapProcessInterval",
]
