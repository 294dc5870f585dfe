"""Unitary operators and the standard gate library (port of
quantpy_tpu/operator.py; numpy only).

The `Operator` class (transform / as_channel / trace / algebra), the
parametric 1-qubit gates PHASE, RX, RY, RZ, the constants Id X Y Z H T S,
the two-qubit gates CNOT CY CZ SWAP ISWAP MS, the three-qubit Toffoli and
Fredkin, and Choi -> Kraus extraction.
"""

from __future__ import annotations

import math
from copy import deepcopy

import numpy as np

from .base import BaseQuantum
from .ops.paulis import PAULI_1
from .qobj import Qobj

__all__ = [
    "Operator",
    "PHASE",
    "RX",
    "RY",
    "RZ",
    "Id",
    "X",
    "Y",
    "Z",
    "H",
    "T",
    "S",
    "CNOT",
    "CY",
    "CZ",
    "SWAP",
    "ISWAP",
    "MS",
    "Toffoli",
    "Fredkin",
    "choi_to_kraus",
]


def _np_unvec(v: np.ndarray) -> np.ndarray:
    """Column-stacking un-vectorization."""
    d = int(round(math.sqrt(v.shape[-1])))
    return v.reshape(d, d).T


class Operator(BaseQuantum):
    """A quantum operator (typically a gate) in matrix form."""

    def __init__(self, data):
        if isinstance(data, Operator):
            self.__dict__ = deepcopy(data.__dict__)
            return
        self._matrix = np.asarray(
            data.matrix if isinstance(data, Qobj) else data, dtype=np.complex128
        )
        self.n_qubits = int(round(math.log2(self._matrix.shape[0])))

    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    @matrix.setter
    def matrix(self, data):
        self._matrix = np.asarray(data, dtype=np.complex128)
        self.n_qubits = int(round(math.log2(self._matrix.shape[0])))

    def transform(self, state) -> Qobj:
        """Conjugation U rho U^H."""
        rho = state.matrix if hasattr(state, "matrix") else np.asarray(state)
        return Qobj(self._matrix @ rho @ self._matrix.conj().T)

    def as_channel(self):
        """This unitary as a quantum Channel."""
        from .channel import Channel

        return Channel(self.transform, self.n_qubits)

    def trace(self):
        return np.trace(self._matrix)

    def __repr__(self):
        return "Quantum Operator\n" + repr(self._matrix)


# -- parametric single-qubit gates ----


def PHASE(theta: float) -> Operator:  # noqa: N802
    """diag(1, e^{i theta})."""
    return Operator(np.diag([1.0, np.exp(1j * theta)]))


def RX(theta: float) -> Operator:  # noqa: N802
    """Rotation about X by theta."""
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return Operator(np.array([[c, -1j * s], [-1j * s, c]]))


def RY(theta: float) -> Operator:  # noqa: N802
    """Rotation about Y by theta."""
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return Operator(np.array([[c, -s], [s, c]]))


def RZ(theta: float) -> Operator:  # noqa: N802
    """Rotation about Z by theta."""
    return Operator(np.diag([np.exp(-0.5j * theta), np.exp(0.5j * theta)]))


# -- constant gates -------------------

Id = Operator(PAULI_1[0])
X = Operator(PAULI_1[1])
Y = Operator(PAULI_1[2])
Z = Operator(PAULI_1[3])
H = Operator(np.array([[1, 1], [1, -1]]) / np.sqrt(2))
T = PHASE(np.pi / 4)
S = PHASE(np.pi / 2)


def _controlled(u: np.ndarray) -> np.ndarray:
    """Block-diagonal controlled gate: |0><0| (x) I + |1><1| (x) U."""
    d = u.shape[0]
    out = np.eye(2 * d, dtype=np.complex128)
    out[d:, d:] = u
    return out


CNOT = Operator(_controlled(PAULI_1[1]))
CY = Operator(_controlled(PAULI_1[2]))
CZ = Operator(_controlled(PAULI_1[3]))

SWAP = Operator(
    np.array(
        [
            [1, 0, 0, 0],
            [0, 0, 1, 0],
            [0, 1, 0, 0],
            [0, 0, 0, 1],
        ],
        dtype=np.complex128,
    )
)

ISWAP = Operator(
    np.array(
        [
            [1, 0, 0, 0],
            [0, 0, 1j, 0],
            [0, 1j, 0, 0],
            [0, 0, 0, 1],
        ],
        dtype=np.complex128,
    )
)

# Molmer-Sorensen gate = (I - i Y(x)Y)/sqrt(2)
MS = Operator(
    (np.eye(4) - 1j * np.kron(PAULI_1[2], PAULI_1[2])) / np.sqrt(2)
)

Toffoli = Operator(_controlled(_controlled(PAULI_1[1])))
Fredkin = Operator(_controlled(SWAP.matrix))


def choi_to_kraus(choi: Qobj, eps: float = 1e-15) -> list:
    """Kraus operators from a Choi matrix via eigendecomposition, keeping
    |eigenvalue| > eps.

    Uses the Hermitian eigendecomposition (the Choi matrix of any channel in
    this library is Hermitian), so eigenvalues come out real/ascending.
    """
    evals, evecs = np.linalg.eigh(choi.matrix)
    kraus = []
    for val, v in zip(evals, evecs.T):
        if abs(val) > eps:
            kraus.append(Operator(_np_unvec(v) * np.sqrt(complex(val))))
    return kraus
