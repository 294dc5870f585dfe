"""Qobj — density matrices and Hermitian operators (port of quantpy_tpu/qobj.py).

A host object over numpy arrays with lazy, mutually invalidating `matrix`
and `bloch` views. Construct it from a complex matrix (2-D), a bloch vector
(1-D; a length that is not a power of 4 is padded into a unit-trace bloch
vector) or a ket (`is_ket=True`). `bloch_tensor(device, dtype)` exports
the real representation that the batched tomography layer consumes.
"""

from __future__ import annotations

import math
import sys
from copy import deepcopy

import numpy as np
import torch

from .base import BaseQuantum
from .config import get_device, rdtype
from .ops.paulis import np_bloch_to_matrix, np_matrix_to_bloch

__all__ = ["Qobj", "fully_mixed", "GHZ", "zero"]


def _ket_to_density(psi) -> np.ndarray:
    """|psi><psi| from a ket vector."""
    psi = np.asarray(psi, dtype=np.complex128).reshape(-1)
    return np.outer(psi, psi.conj())


class Qobj(BaseQuantum):
    """Quantum state / Hermitian operator with matrix and bloch views.

    Parameters
    ----------
    data : array-like or Qobj
        2-D: complex matrix. 1-D with `is_ket=False`: bloch vector
        (padded into a unit-trace vector if its length is not a power of 4).
        1-D with `is_ket=True`: ket vector.
    is_ket : bool, default=False
    """

    def __init__(self, data, is_ket: bool = False):
        if isinstance(data, Qobj):
            self.__dict__ = deepcopy(data.__dict__)
            return
        self._matrix = None
        self._bloch = None
        if is_ket:
            data = _ket_to_density(data)
        data = np.asarray(data)
        if data.ndim == 1:
            n_float = math.log2(data.shape[0]) / 2
            self.n_qubits = math.ceil(n_float)
            dim = 2**self.n_qubits
            if n_float.is_integer():
                self._bloch = np.asarray(data, dtype=np.float64)
            else:
                padded = np.ones(dim * dim, dtype=np.float64) / dim
                padded[1 : 1 + data.shape[0]] = data
                self._bloch = padded
        elif data.ndim == 2:
            self._matrix = np.asarray(data, dtype=np.complex128)
            self.n_qubits = int(round(math.log2(data.shape[0])))
        else:
            raise ValueError("Invalid data format")

    @property
    def matrix(self) -> np.ndarray:
        """Complex matrix view (computed lazily from bloch)."""
        if self._matrix is None:
            self._matrix = np_bloch_to_matrix(self._bloch, self.n_qubits)
        return self._matrix

    @matrix.setter
    def matrix(self, data):
        self._matrix = np.asarray(data, dtype=np.complex128)
        self._bloch = None

    @property
    def bloch(self) -> np.ndarray:
        """Real Pauli-basis (bloch) view (computed lazily from matrix)."""
        if self._bloch is None:
            self._bloch = np_matrix_to_bloch(self._matrix)
        return self._bloch

    @bloch.setter
    def bloch(self, data):
        self._bloch = np.asarray(data, dtype=np.float64)
        self._matrix = None

    def bloch_tensor(self, device=None, dtype=None) -> torch.Tensor:
        """Real bloch vector as a tensor (default dtype and device: the
        port's)."""
        return torch.as_tensor(
            self.bloch, dtype=dtype or rdtype(), device=device or get_device()
        )

    def bloch_device(self) -> torch.Tensor:
        """Real bloch vector as a tensor on the default device in the
        default dtype (`bloch_tensor()`)."""
        return self.bloch_tensor()

    def ptrace(self, keep=(0,)) -> "Qobj":
        """Partial trace keeping qubit indices `keep`."""
        n = self.n_qubits
        keep = sorted(int(k) for k in keep)
        rho = self.matrix.reshape((2,) * (2 * n))
        traced = [q for q in range(n) if q not in keep]
        for idx, q in enumerate(traced):
            pos = q - sum(1 for t in traced[:idx] if t < q)
            rho = np.trace(rho, axis1=pos, axis2=pos + n - idx)
        d = 2 ** len(keep)
        return Qobj(rho.reshape(d, d))

    def schmidt(self):
        """Schmidt decomposition of a pure bipartite state: the SVD of the
        ket reshaped to (2^(n/2), 2^(n/2))."""
        half_dim = 2 ** (self.n_qubits // 2)
        return np.linalg.svd(np.reshape(self.ket(), (half_dim, half_dim)))

    def eig(self):
        """Eigenvalues and right eigenvectors (columns)."""
        return np.linalg.eig(self.matrix)

    def eigh(self):
        """Hermitian eigendecomposition (ascending eigenvalues)."""
        return np.linalg.eigh(self.matrix)

    def is_density_matrix(self, verbose: bool = True) -> bool:
        """Hermitian, positive semi-definite and of unit trace."""
        m = self.matrix
        herm = np.allclose(m, m.conj().T)
        if herm:
            pos = bool(np.all(np.linalg.eigvalsh(m) > -1e-8))
        else:
            pos = bool(np.all(np.real(np.linalg.eigvals(m)) > -1e-8))
        unit = np.allclose(np.trace(m), 1)
        if herm and pos and unit:
            return True
        if verbose:
            if not herm:
                print("Non-hermitian", file=sys.stderr)
            if not pos:
                print("Non-positive", file=sys.stderr)
            if not unit:
                print("Trace is not 1", file=sys.stderr)
        return False

    def trace(self):
        """Matrix trace."""
        return np.trace(self.matrix)

    def impurity(self):
        """1 - Tr(rho^2)."""
        return 1 - np.trace(self.matrix @ self.matrix)

    def is_pure(self) -> bool:
        """Whether this is a valid rank-1 density matrix."""
        return bool(np.allclose(self.impurity(), 0)) and self.is_density_matrix(
            verbose=False
        )

    def ket(self) -> np.ndarray:
        """Ket vector of a pure state (the eigenvector of the largest
        eigenvalue)."""
        if not self.is_pure():
            raise ValueError("Quantum object is not pure")
        return np.linalg.eigh(self.matrix)[1][:, -1]

    def __repr__(self):
        return "Quantum object\n" + repr(self.matrix)

    def _repr_latex_(self):
        """Compact LaTeX matrix rendering for notebooks."""
        return _matrix_to_latex("Quantum object: ", self.matrix)


def _format_entry(z: complex) -> str:
    atol = 1e-4

    def fmt(x: float) -> str:
        if x == 0.0:
            return "0.0"
        if abs(x) >= 1000.0 or abs(x) < 0.001:
            return f"{x:.3e}".replace("e", r"\times10^{") + "}"
        if abs(x - round(x)) < 0.001:
            return f"{x:.1f}"
        return f"{x:.3f}"

    re, im = np.real(z), np.imag(z)
    if abs(im) < atol:
        return fmt(re)
    if abs(re) < atol:
        return fmt(im) + "j"
    sign = "+" if im > 0 else ""
    return f"({fmt(re)}{sign}{fmt(im)}j)"


def _matrix_to_latex(prefix: str, m: np.ndarray, max_rows: int = 10) -> str:
    """Render a (possibly truncated) matrix as a LaTeX array."""
    rows, cols = m.shape
    if rows > max_rows or cols > max_rows:
        r_idx = list(range(5)) + [None] + list(range(rows - 5, rows))
        c_idx = list(range(5)) + [None] + list(range(cols - 5, cols))
    else:
        r_idx = list(range(rows))
        c_idx = list(range(cols))
    body_rows = []
    for r in r_idx:
        cells = []
        for c in c_idx:
            if r is None:
                cells.append(r"\ddots" if c is None else r"\vdots")
            elif c is None:
                cells.append(r"\cdots")
            else:
                cells.append(_format_entry(m[r, c]))
        body_rows.append(" & ".join(cells))
    body = r"\\".join(body_rows)
    return (
        prefix
        + r"\begin{equation*}\left(\begin{array}{*{11}c}"
        + body
        + r"\\\end{array}\right)\end{equation*}"
    )


def fully_mixed(n_qubits: int = 1) -> Qobj:
    """Maximally mixed state I / 2^n."""
    dim = 2**n_qubits
    return Qobj(np.eye(dim, dtype=np.complex128) / dim)


def GHZ(n_qubits: int = 3) -> Qobj:  # noqa: N802 - reference API name
    """GHZ state (|0...0> + |1...1>) / sqrt(2)."""
    dim = 2**n_qubits
    ket = np.zeros(dim)
    ket[0] = ket[-1] = 1 / np.sqrt(2)
    return Qobj(ket, is_ket=True)


def zero(n_qubits: int = 1) -> Qobj:
    """Computational-basis zero state |0...0>."""
    dim = 2**n_qubits
    ket = np.zeros(dim)
    ket[0] = 1
    return Qobj(ket, is_ket=True)
