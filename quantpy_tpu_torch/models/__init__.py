"""Model families of the tomography domain (port of
quantpy_tpu/models/__init__.py).

The "models" are the quantum objects experiments are run on: canonical
states, the unitary gate library and the standard CPTP channel families.
This package groups their constructors; the classes live in `qobj`,
`operator` and `channel`.
"""

from ..channel import (
    amplitude_damping,
    dephasing,
    depolarize,
    depolarizing,
    walsh_hadamard,
)
from ..operator import (
    CNOT, CY, CZ, Fredkin, H, ISWAP, Id, MS, PHASE, RX, RY, RZ, S, SWAP, T,
    Toffoli, X, Y, Z,
)
from ..qobj import GHZ, fully_mixed, zero

__all__ = [
    "GHZ", "fully_mixed", "zero",
    "Id", "X", "Y", "Z", "H", "T", "S", "PHASE", "RX", "RY", "RZ",
    "CNOT", "CY", "CZ", "SWAP", "ISWAP", "MS", "Toffoli", "Fredkin",
    "depolarizing", "dephasing", "amplitude_damping", "walsh_hadamard",
    "depolarize",
]
