"""State tomography: the functional core, the bootstrap and the user API."""

from .interval import BootstrapStateInterval
from .state import StateTomograph

__all__ = ["StateTomograph", "BootstrapStateInterval"]
