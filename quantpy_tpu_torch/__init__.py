"""quantpy_tpu_torch — the PyTorch/CUDA port of quantpy_tpu.

It carries the state and process estimators of the JAX package: POVM designs,
multinomial simulation, linear inversion with the eigh clip, the RrhoR
fixed point ('mle-rhor'; a hand-written CUDA kernel on the GPU for float32
batches), the Cholesky-parametrized MLE by batched L-BFGS ('mle',
'mle-constr'), distances, the StateTomograph and the bootstrap interval.
Designs of 6 or more qubits run on the kron-factored chains
(`tomography.kron_core`), which never materialize the POVM. Process
tomography (`ProcessTomograph`, `BootstrapProcessInterval`) estimates
channels by linear inversion with the CPTP projection ('lifp'), projected
gradient descent ('pgdb'), Davis-Yin splitting ('dys') or per-state
reconstruction ('states'), on the host objects `Channel`, `Operator` and
`Basis`. The analytic confidence intervals (`MomentInterval`,
`SugiyamaInterval`, the moment-fidelity and polytope bands and
`HolderInterval`) run on `stats`, `convex` (closed-form ball bounds and
batched PDHG linear programs) and `tomography.kron_analytic`; the
coverage harness of the confidence polytopes is
`tomography.polytopes.verification`.

The default device is the card, ``cuda`` (`config.get_device()`); CPU work
is asked for with ``config.set_device("cpu")`` or ``device="cpu"``.
"""

from . import basis, channel, config, convex, operator, qobj, routines, stats
from .base import BaseQuantum
from .basis import Basis
from .channel import (
    Channel,
    amplitude_damping,
    dephasing,
    depolarize,
    depolarizing,
    walsh_hadamard,
)
from .config import cdtype, get_device, rdtype, set_device, set_dtype
from .measurements import generate_measurement_matrix
from .operator import Operator
from .ops.geometry import fidelity, hs_dst, if_dst, product, trace_dst
from .ops.paulis import generate_pauli
from .qobj import GHZ, Qobj, fully_mixed, zero
from .routines import join_gates, kron
from .tomography.interval import (
    BootstrapProcessInterval,
    BootstrapStateInterval,
    HolderInterval,
    MomentFidelityProcessInterval,
    MomentFidelityStateInterval,
    MomentInterval,
    PolytopeProcessInterval,
    PolytopeStateInterval,
    SugiyamaInterval,
)
from .tomography.process import ProcessTomograph
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
    "BaseQuantum",
    "Basis",
    "Channel",
    "Operator",
    "ProcessTomograph",
    "BootstrapProcessInterval",
    "MomentInterval",
    "MomentFidelityStateInterval",
    "MomentFidelityProcessInterval",
    "SugiyamaInterval",
    "PolytopeStateInterval",
    "PolytopeProcessInterval",
    "HolderInterval",
    "depolarizing",
    "dephasing",
    "amplitude_damping",
    "walsh_hadamard",
    "depolarize",
    "generate_pauli",
    "join_gates",
    "kron",
    "basis",
    "channel",
    "operator",
    "qobj",
    "routines",
    "convex",
    "stats",
]
