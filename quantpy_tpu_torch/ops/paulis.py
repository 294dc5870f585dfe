"""Pauli-basis transforms (port of quantpy_tpu/ops/paulis.py).

Two forms of the bloch <-> matrix map, as in the JAX package:

1. Factored contractions in groups of up to three qubits
   (`bloch_to_matrix` / `matrix_to_bloch`): O(n 4^n) work per item, no
   dense n-qubit basis.
2. A dense Pauli transfer matrix (`pauli_transfer_matrix`) mapping a bloch
   vector to vec(matrix) in one product, for n <= PTM_MAX_QUBITS. The RrhoR
   kernel and its plain version use it.

Conventions: Pauli order I, X, Y, Z per qubit, lexicographic over qubits;
A = sum_i b_i P_i, so b_i = Re Tr(P_i A) / 2^n; vec() stacks columns.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import complex_dtype, get_device, rdtype

__all__ = [
    "PAULI_1",
    "PTM_MAX_QUBITS",
    "n_qubits_from_dim",
    "generate_pauli",
    "pauli_transpose_signs",
    "pauli_transfer_matrix",
    "bloch_to_matrix",
    "matrix_to_bloch",
    "np_bloch_to_matrix",
    "np_matrix_to_bloch",
    "vec",
    "unvec",
    "kron_all",
    "ptrace",
]

_PAULI_1_NP = np.array(
    [
        [[1, 0], [0, 1]],
        [[0, 1], [1, 0]],
        [[0, -1j], [1j, 0]],
        [[1, 0], [0, -1]],
    ],
    dtype=np.complex128,
)

PAULI_1 = _PAULI_1_NP

#: largest qubit count with a dense (4^n, 4^n) transfer matrix
PTM_MAX_QUBITS = 6

#: qubits per group in the factored transforms
TRANSFORM_GROUP = 3


def n_qubits_from_dim(dim: int) -> int:
    """Number of qubits for a 2^n matrix dimension."""
    n = int(round(math.log2(dim)))
    if 2**n != dim:
        raise ValueError(f"Dimension {dim} is not a power of two")
    return n


@functools.lru_cache(maxsize=None)
def _pauli_basis_np(n_qubits: int) -> np.ndarray:
    """Dense (4^n, 2^n, 2^n) Pauli basis (numpy, complex128)."""
    basis = _PAULI_1_NP
    for _ in range(n_qubits - 1):
        basis = np.kron(basis, _PAULI_1_NP)
    return basis


def generate_pauli(n_qubits: int, dtype=None, device=None) -> torch.Tensor:
    """The dense Pauli basis as one (4^n, 2^n, 2^n) complex tensor, of the
    precision of the real dtype `dtype`, on `device` (defaults: the
    port's)."""
    return torch.as_tensor(
        _pauli_basis_np(n_qubits),
        dtype=complex_dtype(dtype or rdtype()),
        device=device or get_device(),
    )


@functools.lru_cache(maxsize=None)
def pauli_transpose_signs(n_qubits: int) -> np.ndarray:
    """(4^n,) signs s with P_a^T = s_a P_a: -1 iff the multi-index holds an
    odd number of Y factors, so bloch(rho^T) = signs * bloch(rho)."""
    idx = np.arange(4**n_qubits)
    y_count = np.zeros(4**n_qubits, dtype=np.int64)
    for _ in range(n_qubits):
        y_count += (idx % 4) == 2
        idx //= 4
    return np.where(y_count % 2 == 1, -1.0, 1.0)


@functools.lru_cache(maxsize=None)
def _pauli_transfer_np(n_qubits: int) -> np.ndarray:
    """(4^n, 4^n) complex matrix M with M[:, i] = vec(P_i) (column-stacking)."""
    basis = _pauli_basis_np(n_qubits)
    return np.ascontiguousarray(
        basis.transpose(0, 2, 1).reshape(basis.shape[0], -1).T
    )


def pauli_transfer_matrix(n_qubits: int, dtype=None, device=None) -> torch.Tensor:
    """The bloch -> vec(matrix) transfer matrix as a complex tensor of the
    precision of the real dtype `dtype`, on `device` (defaults: the
    port's)."""
    if n_qubits > PTM_MAX_QUBITS:
        raise ValueError(
            f"Dense Pauli transfer matrix capped at {PTM_MAX_QUBITS} qubits; "
            "use the factored bloch_to_matrix/matrix_to_bloch instead"
        )
    return torch.as_tensor(
        _pauli_transfer_np(n_qubits),
        dtype=complex_dtype(dtype or rdtype()),
        device=device or get_device(),
    )


def group_sizes(n_qubits: int, group: int = TRANSFORM_GROUP) -> tuple[int, ...]:
    """Split n qubits into contraction groups of at most `group` qubits; a
    remainder of 1 is folded into the last full group as (2, 2)."""
    full, rem = divmod(n_qubits, group)
    if rem == 1 and full >= 1:
        return (group,) * (full - 1) + (2, 2)
    return (group,) * full + ((rem,) if rem else ())


@functools.lru_cache(maxsize=None)
def _group_basis_flat(g: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(4^g, 4^g) tensor B[i, a*2^g+b] = (g-qubit Pauli basis)_i[a, b]."""
    return torch.as_tensor(
        _pauli_basis_np(g).reshape(4**g, 4**g), dtype=dtype, device=device
    )


def bloch_to_matrix(bloch: torch.Tensor, n_qubits: int | None = None) -> torch.Tensor:
    """Bloch vectors (..., 4^n) -> complex matrices (..., 2^n, 2^n), in the
    complex dtype of the bloch vectors' precision."""
    if n_qubits is None:
        n_qubits = n_qubits_from_dim(int(round(math.sqrt(bloch.shape[-1]))))
    dim = 2**n_qubits
    groups = group_sizes(n_qubits)
    k = len(groups)
    batch_shape = tuple(bloch.shape[:-1])
    bdim = len(batch_shape)
    ct = complex_dtype(bloch.dtype)
    t = bloch.to(ct).reshape(batch_shape + tuple(4**g for g in groups))
    for g in groups:
        t = torch.tensordot(t, _group_basis_flat(g, ct, bloch.device), dims=([bdim], [0]))
    t = t.reshape(batch_shape + sum(((2**g, 2**g) for g in groups), ()))
    perm = (
        list(range(bdim))
        + [bdim + 2 * j for j in range(k)]
        + [bdim + 2 * j + 1 for j in range(k)]
    )
    return t.permute(perm).reshape(batch_shape + (dim, dim))


def matrix_to_bloch(matrix: torch.Tensor) -> torch.Tensor:
    """Complex matrices (..., 2^n, 2^n) -> real bloch vectors (..., 4^n),
    b_i = Re Tr(P_i A) / 2^n."""
    if not matrix.is_complex():
        matrix = matrix.to(complex_dtype(matrix.dtype))
    dim = matrix.shape[-1]
    n = n_qubits_from_dim(dim)
    groups = group_sizes(n)
    k = len(groups)
    batch_shape = tuple(matrix.shape[:-2])
    bdim = len(batch_shape)
    t = matrix.reshape(batch_shape + tuple(2**g for g in groups) * 2)
    perm = list(range(bdim))
    for j in range(k):
        perm += [bdim + k + j, bdim + j]
    t = t.permute(perm).reshape(batch_shape + tuple(4**g for g in groups))
    for g in groups:
        t = torch.tensordot(
            t, _group_basis_flat(g, matrix.dtype, matrix.device), dims=([bdim], [1])
        )
    return (t.real / dim).reshape(batch_shape + (4**n,))


def vec(matrix: torch.Tensor) -> torch.Tensor:
    """Column-stacking vectorization."""
    return matrix.transpose(-1, -2).reshape(tuple(matrix.shape[:-2]) + (-1,))


def unvec(vector: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`vec`."""
    d = int(round(math.sqrt(vector.shape[-1])))
    return vector.reshape(tuple(vector.shape[:-1]) + (d, d)).transpose(-1, -2)


def kron_all(matrices) -> torch.Tensor:
    """Kronecker product of a sequence of matrices, left to right."""
    out = torch.as_tensor(matrices[0])
    for m in matrices[1:]:
        out = torch.kron(out, torch.as_tensor(m, device=out.device))
    return out


def ptrace(matrix: torch.Tensor, keep, n_qubits: int | None = None) -> torch.Tensor:
    """Partial trace keeping the qubits in `keep` (in ascending order), with
    leading batch dimensions."""
    matrix = torch.as_tensor(matrix)
    n = n_qubits_from_dim(matrix.shape[-1]) if n_qubits is None else n_qubits
    keep = sorted(int(k) for k in keep)
    traced = [i for i in range(n) if i not in keep]
    batch_shape = tuple(matrix.shape[:-2])
    bdim = len(batch_shape)
    t = matrix.reshape(batch_shape + (2,) * (2 * n))
    # row axes bdim..bdim+n-1, column axes bdim+n..bdim+2n-1; each trace
    # removes one of either, so later positions shift
    for idx, q in enumerate(traced):
        row_ax = bdim + (q - sum(1 for t_ in traced[:idx] if t_ < q))
        col_ax = row_ax + (n - idx)
        t = torch.diagonal(t, dim1=row_ax, dim2=col_ax).sum(-1)
    d_keep = 2 ** len(keep)
    return t.reshape(batch_shape + (d_keep, d_keep))


# Host-side (numpy) forms of the factored transforms, used by Qobj.


def np_bloch_to_matrix(bloch: np.ndarray, n_qubits: int | None = None) -> np.ndarray:
    """Numpy twin of :func:`bloch_to_matrix`."""
    bloch = np.asarray(bloch)
    if n_qubits is None:
        n_qubits = n_qubits_from_dim(int(round(math.sqrt(bloch.shape[-1]))))
    n = n_qubits
    dim = 2**n
    batch_shape = bloch.shape[:-1]
    p4 = _PAULI_1_NP.reshape(4, 4)
    t = bloch.astype(np.complex128).reshape(batch_shape + (4,) * n)
    bdim = len(batch_shape)
    for _ in range(n):
        t = np.tensordot(t, p4, axes=[[bdim], [0]])
    t = t.reshape(batch_shape + (2, 2) * n)
    perm = (
        list(range(bdim))
        + [bdim + 2 * k for k in range(n)]
        + [bdim + 2 * k + 1 for k in range(n)]
    )
    return t.transpose(perm).reshape(batch_shape + (dim, dim))


def np_matrix_to_bloch(matrix: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`matrix_to_bloch`."""
    matrix = np.asarray(matrix, dtype=np.complex128)
    dim = matrix.shape[-1]
    n = n_qubits_from_dim(dim)
    batch_shape = matrix.shape[:-2]
    bdim = len(batch_shape)
    t = matrix.reshape(batch_shape + (2,) * (2 * n))
    perm = list(range(bdim))
    for k in range(n):
        perm += [bdim + n + k, bdim + k]
    t = t.transpose(perm).reshape(batch_shape + (4,) * n)
    p4 = _PAULI_1_NP.reshape(4, 4)
    for _ in range(n):
        t = np.tensordot(t, p4, axes=[[bdim], [1]])
    return (t.real / dim).reshape(batch_shape + (4**n,))
