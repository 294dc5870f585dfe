"""Cholesky (real-vector) parametrization of PSD matrices, batched (port of
quantpy_tpu/ops/cholesky.py).

For a d x d matrix the parameter vector is

    [diag_0 .. diag_{d-1},
     Re(strictly-lower entries, row-major tril order),
     Im(strictly-lower entries, row-major tril order)]

of total length d + d(d-1) = d^2. The matrix is recovered as L L^H. The
tensor functions take leading batch axes, follow the dtype and device of
their argument, and `real_tril_vec_to_matrix` is differentiable by
autograd.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import as_real, complex_dtype

__all__ = [
    "real_tril_vec_to_matrix",
    "matrix_to_real_tril_vec",
    "tril_param_dim",
    "matrix_dim_from_param",
    "np_real_tril_vec_to_matrix",
    "np_matrix_to_real_tril_vec",
]


def tril_param_dim(d: int) -> int:
    """Length of the parameter vector for a d x d matrix: d + d(d-1)."""
    return d * d


def matrix_dim_from_param(length: int) -> int:
    """Matrix dimension from the parameter-vector length (d^2 = length)."""
    d = int(round(math.sqrt(length)))
    if d * d != length:
        raise ValueError(f"Invalid Cholesky parameter length {length}")
    return d


@functools.lru_cache(maxsize=None)
def _tril_indices_np(d: int):
    rows, cols = np.tril_indices(d, -1)
    return rows, cols


@functools.lru_cache(maxsize=16)
def _flat_positions(d: int, device: torch.device):
    """(re_pos, im_pos): where the parameters land in the row-major d*d
    flattening of L. re_pos (d + d(d-1)/2,) takes the diagonal then the real
    strict-lower parts; im_pos (d(d-1)/2,) the imaginary ones."""
    rows, cols = _tril_indices_np(d)
    off = rows * d + cols
    re_pos = np.concatenate([np.arange(d) * (d + 1), off])
    return (torch.as_tensor(re_pos, device=device), torch.as_tensor(off, device=device))


def real_tril_vec_to_matrix(vector, d: int | None = None) -> torch.Tensor:
    """L L^H from the real parameter vectors (..., d^2), as complex
    matrices (..., d, d)."""
    vector = as_real(vector)
    if d is None:
        d = matrix_dim_from_param(vector.shape[-1])
    batch_shape = tuple(vector.shape[:-1])
    n_re = d + d * (d - 1) // 2
    re_pos, im_pos = _flat_positions(d, vector.device)
    zeros = vector.new_zeros(batch_shape + (d * d,))
    re = zeros.index_copy(-1, re_pos, vector[..., :n_re])
    im = zeros.index_copy(-1, im_pos, vector[..., n_re:])
    tril = torch.complex(re, im).reshape(batch_shape + (d, d))
    return tril @ tril.conj().transpose(-1, -2)


def matrix_to_real_tril_vec(matrix) -> torch.Tensor:
    """The parameter vectors (..., d^2) of PSD Hermitian matrices
    (..., d, d), from their lower Cholesky factors. Like the JAX package,
    this needs strict positive definiteness: clip the eigenvalues first for
    states on the boundary."""
    if not matrix.is_complex():
        matrix = matrix.to(complex_dtype(matrix.dtype))
    d = matrix.shape[-1]
    tril = torch.linalg.cholesky(matrix)
    rows, cols = _tril_indices_np(d)
    rows = torch.as_tensor(rows, device=matrix.device)
    cols = torch.as_tensor(cols, device=matrix.device)
    diag = tril.diagonal(dim1=-2, dim2=-1).real
    off = tril[..., rows, cols]
    return torch.cat([diag, off.real, off.imag], dim=-1)


# Host-side (numpy) twins, for the object layer.


def np_matrix_to_real_tril_vec(matrix: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`matrix_to_real_tril_vec`."""
    matrix = np.asarray(matrix, dtype=np.complex128)
    d = matrix.shape[-1]
    tril = np.linalg.cholesky(matrix)
    rows, cols = _tril_indices_np(d)
    didx = np.arange(d)
    diag = tril[..., didx, didx].real
    off = tril[..., rows, cols]
    return np.concatenate([diag, off.real, off.imag], axis=-1)


def np_real_tril_vec_to_matrix(vector: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`real_tril_vec_to_matrix`."""
    vector = np.asarray(vector, dtype=np.float64)
    d = matrix_dim_from_param(vector.shape[-1])
    batch_shape = vector.shape[:-1]
    n_off = d * (d - 1) // 2
    diag = vector[..., :d]
    re = vector[..., d : d + n_off]
    im = vector[..., d + n_off :]
    rows, cols = _tril_indices_np(d)
    tril = np.zeros(batch_shape + (d, d), dtype=np.complex128)
    tril[..., rows, cols] = re + 1j * im
    didx = np.arange(d)
    tril[..., didx, didx] = diag
    return tril @ np.swapaxes(tril.conj(), -1, -2)
