"""Pauli-basis transforms: a Hermitian matrix A = sum_a b_a P_a, with
b_a = Re Tr(P_a A) / 2^n, Pauli order I, X, Y, Z per qubit and the first
qubit most significant (np.kron order)."""

from __future__ import annotations

import numpy as np
import torch

PAULI = np.array(
    [
        [[1, 0], [0, 1]],
        [[0, 1], [1, 0]],
        [[0, -1j], [1j, 0]],
        [[1, 0], [0, -1]],
    ],
    dtype=np.complex128,
)

COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _pauli(cdtype, device):
    return torch.as_tensor(PAULI, dtype=cdtype, device=device)


def bloch_to_matrix(b: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 4^n) real -> (..., 2^n, 2^n) complex, one qubit at a time."""
    lead = tuple(b.shape[:-1])
    x = b.reshape(lead + (4,) * n).to(COMPLEX_OF[b.dtype])
    p = _pauli(x.dtype, x.device)
    for _ in range(n):
        # contract the first Pauli axis left; its (row, col) pair goes last
        x = torch.tensordot(x, p, dims=([len(lead)], [0]))
    k = len(lead)
    perm = list(range(k)) + [k + 2 * q for q in range(n)] + [k + 2 * q + 1 for q in range(n)]
    return x.permute(perm).reshape(lead + (2**n, 2**n))


def matrix_to_bloch(a: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2^n, 2^n) -> (..., 4^n) real: Re Tr(P_a A) / 2^n."""
    lead = tuple(a.shape[:-2])
    x = a.reshape(lead + (2,) * (2 * n))
    # Tr(P A) = sum_{r,c} P[c, r] A[r, c]
    pt = _pauli(a.dtype, a.device).transpose(1, 2)
    k = len(lead)
    for step in range(n):
        x = torch.tensordot(x, pt, dims=([k, k + n - step], [1, 2]))
    return x.reshape(lead + (4**n,)).real / 2**n


def transpose_signs(n: int) -> np.ndarray:
    """s_a with P_a^T = s_a P_a: -1 where the index holds an odd number of Y."""
    digits = (np.arange(4**n)[:, None] // 4 ** np.arange(n)[None, :]) % 4
    return np.where((digits == 2).sum(1) % 2 == 1, -1.0, 1.0)


def cmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex product through real matrix products, so that the precision
    settings of real float32 products (TF32) govern it."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)
