"""Small helpers under the reference library's names (port of
quantpy_tpu/routines.py): single-entry matrices, gate joining, the
column-stacking vec maps, and re-exports of the Cholesky maps and the left
inverse from `ops`.
"""

from __future__ import annotations

import numpy as np

from .ops.cholesky import (
    matrix_to_real_tril_vec,
    np_matrix_to_real_tril_vec,
    np_real_tril_vec_to_matrix,
    real_tril_vec_to_matrix,
)
from .ops.lstsq import left_inverse
from .ops.paulis import PAULI_1, generate_pauli

__all__ = [
    "generate_pauli",
    "generate_single_entries",
    "kron",
    "join_gates",
    "matrix_to_real_tril_vec",
    "real_tril_vec_to_matrix",
    "left_inv_device",
]

_SIGMA_I, _SIGMA_X, _SIGMA_Y, _SIGMA_Z = PAULI_1


def generate_single_entries(dim: int) -> list:
    """All dim x dim matrices with a single unit entry, row-major."""
    out = []
    for i in range(dim):
        for j in range(dim):
            e = np.zeros((dim, dim), dtype=np.complex128)
            e[i, j] = 1.0
            out.append(e)
    return out


def kron(a, b):
    """Kronecker product of two quantum objects."""
    return a.kron(b)


def join_gates(gates):
    """Compose gates applied left to right."""
    out = gates[0]
    for g in gates[1:]:
        out = g @ out
    return out


def _vec2mat(vector):
    """Column-stacking un-vectorization."""
    vector = np.asarray(vector)
    d = int(round(np.sqrt(vector.shape[-1])))
    return vector.reshape(vector.shape[:-1] + (d, d)).swapaxes(-1, -2)


def _mat2vec(matrix):
    """Column-stacking vectorization."""
    matrix = np.asarray(matrix)
    return matrix.swapaxes(-1, -2).reshape(matrix.shape[:-2] + (-1,))


def _density(psi):
    """|psi><psi|."""
    psi = np.asarray(psi, dtype=np.complex128).reshape(-1)
    return np.outer(psi, psi.conj())


def _left_inv(a):
    """(A^T A)^{-1} A^T on the host."""
    a = np.asarray(a)
    return np.linalg.solve(a.T @ a, a.T)


def _real_to_complex(z):
    """Real (2n,) -> complex (n,)."""
    z = np.asarray(z)
    n = z.shape[-1] // 2
    return z[..., :n] + 1j * z[..., n:]


def _complex_to_real(z):
    """Complex (n,) -> real (2n,)."""
    z = np.asarray(z)
    return np.concatenate([z.real, z.imag], axis=-1)


# the Cholesky parametrization on the host (the tensor forms are exported
# above under their own names)
_matrix_to_real_tril_vec = np_matrix_to_real_tril_vec
_real_tril_vec_to_matrix = np_real_tril_vec_to_matrix
left_inv_device = left_inverse
