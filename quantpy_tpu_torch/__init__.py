"""quantpy_tpu_torch — the PyTorch/CUDA port of quantpy_tpu.

This slice carries the bootstrapped RrhoR-MLE main path: POVM designs,
multinomial simulation, linear inversion with the eigh clip, the RrhoR
fixed point (a hand-written CUDA kernel on the GPU), distances, the
StateTomograph and the bootstrap interval. The package picks no device:
the default is the CPU, and GPU work is asked for with ``device="cuda"``.
"""

from . import config
from .config import cdtype, get_device, rdtype, set_device, set_dtype
from .measurements import generate_measurement_matrix
from .ops.geometry import fidelity, hs_dst, if_dst, product, trace_dst
from .qobj import GHZ, Qobj, fully_mixed, zero
from .tomography.interval import BootstrapStateInterval
from .tomography.state import StateTomograph

__all__ = [
    "config",
    "set_dtype",
    "rdtype",
    "cdtype",
    "set_device",
    "get_device",
    "generate_measurement_matrix",
    "Qobj",
    "GHZ",
    "fully_mixed",
    "zero",
    "hs_dst",
    "trace_dst",
    "if_dst",
    "fidelity",
    "product",
    "StateTomograph",
    "BootstrapStateInterval",
]
