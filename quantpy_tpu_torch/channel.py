"""Quantum channels (CPTP maps) with Choi / Kraus / functional views (port
of quantpy_tpu/channel.py; host objects over numpy).

Construction from a transformation function (+ n_qubits), a Choi matrix
(Qobj or array) or a Kraus list; lazy conversion between representations;
`transform`, `is_cptp`, Choi-space algebra; and the standard channels
`depolarizing`, `dephasing`, `amplitude_damping`, `walsh_hadamard`,
`depolarize`.

Choi convention:
    choi = sum_ij |i><j| (x) Phi(|i><j|)
so the first tensor factor is the input space. The Choi matrix of an n-qubit
channel is a 2n-qubit Qobj.
"""

from __future__ import annotations

import sys
from copy import deepcopy

import numpy as np

from .base import BaseQuantum
from .operator import H, Operator, Z, choi_to_kraus
from .qobj import Qobj, fully_mixed
from .routines import generate_single_entries

__all__ = [
    "Channel",
    "depolarizing",
    "dephasing",
    "amplitude_damping",
    "walsh_hadamard",
    "depolarize",
]


class Channel(BaseQuantum):
    """A quantum channel, stored in whichever representation it was built
    from and converted lazily."""

    def __init__(self, data, n_qubits: int | None = None):
        self._choi = None
        self._kraus = None
        self._func = None
        if isinstance(data, Channel):
            self.__dict__ = deepcopy(data.__dict__)
            return
        if callable(data):
            if n_qubits is None:
                raise ValueError(
                    "`n_qubits` argument is compulsory when using init with function"
                )
            self._func = data
            self.n_qubits = n_qubits
        elif isinstance(data, (np.ndarray, Qobj)):
            self._choi = Qobj(data)
            self.n_qubits = self._choi.n_qubits // 2
        elif isinstance(data, list):
            self._kraus = [Operator(k) for k in data]
            self.n_qubits = self._kraus[0].n_qubits
        else:
            raise ValueError("Invalid data format")

    # -- representations -----------------------------------------------------

    def set_func(self, func, n_qubits: int) -> None:
        """Redefine the channel by a transformation function."""
        self._func = func
        self._choi = None
        self._kraus = None
        self.n_qubits = n_qubits

    @property
    def choi(self) -> Qobj:
        """Choi matrix (computed lazily from func/kraus by propagating the
        single-entry matrices)."""
        if self._choi is None:
            dim = 2**self.n_qubits
            # C[(i a), (j b)] = Phi(E_ij)[a, b]: each transformed single
            # entry is written into its block directly
            acc = np.zeros((dim, dim, dim, dim), dtype=np.complex128)
            for idx, e in enumerate(generate_single_entries(dim)):
                i, j = divmod(idx, dim)
                acc[i, :, j, :] = self.transform(Qobj(e)).matrix
            self._choi = Qobj(acc.reshape(dim * dim, dim * dim))
        return self._choi

    @choi.setter
    def choi(self, data):
        self._choi = data if isinstance(data, Qobj) else Qobj(np.asarray(data))
        self._func = None
        self._kraus = None
        self.n_qubits = self._choi.n_qubits // 2

    @property
    def kraus(self) -> list:
        """Kraus representation (lazily from the Choi matrix)."""
        if self._kraus is None:
            self._kraus = choi_to_kraus(self.choi)
        return self._kraus

    @kraus.setter
    def kraus(self, data):
        if not isinstance(data, list):
            raise ValueError("Invalid data format")
        self._kraus = [Operator(k) for k in data]
        self._choi = None
        self._func = None
        self.n_qubits = self._kraus[0].n_qubits

    # -- action --------------------------------------------------------------

    def transform(self, state) -> Qobj:
        """Apply the channel to a state. Dispatch preference: kraus ->
        func -> Choi contraction."""
        if not isinstance(state, Qobj):
            state = Qobj(state)
        if self._kraus is not None:
            dim = 2**self.n_qubits
            out = np.zeros((dim, dim), dtype=np.complex128)
            rho = state.matrix
            for k in self._kraus:
                out += k.matrix @ rho @ k.matrix.conj().T
            return Qobj(out)
        if self._func is not None:
            return self._func(state)
        # Choi action in bloch space: bloch_out = 2^n (signs * bloch_in) @ C
        # with C the (4^n, 4^n)-reshaped Choi bloch
        from .tomography.process_core import np_choi_apply_bloch

        return Qobj(np_choi_apply_bloch(self.choi.bloch, state.bloch))

    def is_cptp(self, atol: float = 1e-5, verbose: bool = True) -> bool:
        """Complete positivity (Choi PSD) and trace preservation
        (Tr_out choi = I)."""
        rho_in = self.choi.ptrace(tuple(range(self.n_qubits)))
        tp = np.allclose(rho_in.matrix, np.eye(2**self.n_qubits), atol=atol)
        evals = np.linalg.eigvalsh(self.choi.matrix)
        cp = bool(np.all(evals > -atol))
        if tp and cp:
            return True
        if verbose:
            if not tp:
                print("Not trace-preserving", file=sys.stderr)
            if not cp:
                print("Not completely positive", file=sys.stderr)
        return False

    # -- algebra on the Choi matrix ------------------------------------------

    @property
    def matrix(self):
        """Choi matrix as an array — lets BaseQuantum algebra act in Choi
        space."""
        return self.choi.matrix

    @matrix.setter
    def matrix(self, data):
        self.choi = Qobj(np.asarray(data))

    def _wrap(self, choi_matrix) -> "Channel":
        return Channel(Qobj(choi_matrix))

    @property
    def T(self) -> "Channel":
        return self._wrap(self.choi.matrix.T)

    @property
    def H(self) -> "Channel":
        return self._wrap(self.choi.matrix.conj().T)

    def conj(self) -> "Channel":
        return self._wrap(self.choi.matrix.conj())

    def __matmul__(self, other):
        """Map composition: ``(a @ b).transform(rho) == a.transform(b.transform(rho))``.

        The matrix product of two Choi matrices is not the Choi matrix of
        the composed map, so this composes the maps themselves, and
        ``U.as_channel() @ V.as_channel() == (U @ V).as_channel()``.

        Representation choice: when both operands already hold Kraus lists
        the composite is the Kraus chain {A_i B_j} (exact, concrete); any
        other pairing composes lazily through `transform` dispatch, which
        avoids forcing an O(16^n) Choi materialization of a functional
        operand just to multiply it.
        """
        if not isinstance(other, Channel):
            raise TypeError(
                "Channel composition requires a Channel on both sides; got "
                f"{type(other).__name__}. Wrap unitaries via `.as_channel()`."
            )
        if self.n_qubits != other.n_qubits:
            raise ValueError(
                f"Cannot compose channels on {self.n_qubits} and "
                f"{other.n_qubits} qubits"
            )
        if self._kraus is not None and other._kraus is not None:
            return Channel(
                [
                    Operator(a.matrix @ b.matrix)
                    for a in self._kraus
                    for b in other._kraus
                ]
            )
        a, b = self, other
        return Channel(
            lambda rho: a.transform(b.transform(rho)), self.n_qubits
        )

    def __repr__(self):
        return "Quantum channel with Choi matrix\n" + repr(self.choi.matrix)

    def _repr_latex_(self):
        return "Choi matrix: " + self.choi._repr_latex_()


# -- standard channels -------------------------------------------------------


def depolarizing(p: float = 1.0, n_qubits: int = 1) -> Channel:
    """rho -> p * Tr(rho) * I/2^n + (1-p) * rho."""
    return Channel(
        lambda rho: p * complex(rho.trace()) * fully_mixed(n_qubits)
        + (1 - p) * rho,
        n_qubits,
    )


def dephasing(p: float = 1.0, n_qubits: int = 1) -> Channel:
    """rho -> (1-p) * rho + p * Z^(x n) rho Z^(x n), the phase flip being
    the tensor power of Z."""
    zn = Z
    for _ in range(n_qubits - 1):
        zn = zn.kron(Z)
    return Channel(lambda rho: p * zn.transform(rho) + (1 - p) * rho, n_qubits)


def amplitude_damping(gamma: float) -> Channel:
    """Single-qubit amplitude damping with decay probability gamma."""
    k0 = np.array([[1, 0], [0, np.sqrt(1 - gamma)]], dtype=np.complex128)
    k1 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=np.complex128)
    return Channel([k0, k1])


def walsh_hadamard(n_qubits: int) -> Channel:
    """Tensor power of the Hadamard gate, as a channel."""
    op = H
    for _ in range(n_qubits - 1):
        op = op.kron(H)
    return op.as_channel()


def depolarize(channel: Channel, p: float) -> Channel:
    """Mix a channel with total depolarization: (1-p) Phi + p Tr(.) I/d."""
    return Channel(
        lambda rho: (1 - p) * channel.transform(rho)
        + p * complex(rho.trace()) * fully_mixed(channel.n_qubits),
        channel.n_qubits,
    )
