"""Operator bases with general (possibly non-orthogonal) elements (port of
quantpy_tpu/basis.py; numpy only).

Used for the input-state basis in process tomography. The Gram matrix is
one matrix product.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Basis"]


def _trace_product(a: np.ndarray, b: np.ndarray) -> complex:
    """Tr(A B^H) = sum_ij A_ij conj(B_ij)."""
    return complex(np.sum(a * b.conj()))


class Basis:
    """Basis of a Euclidean space of matrices.

    Parameters
    ----------
    elements : sequence of Qobj or arrays
        Basis elements.
    inner_product : 'trace' or callable, default='trace'
        Inner product; 'trace' is (A, B) = Tr(A @ B^H).
    """

    def __init__(self, elements, inner_product="trace"):
        self.elements = list(elements)
        self.dim = len(self.elements)
        mats = np.stack(
            [np.asarray(getattr(e, "matrix", e), dtype=np.complex128) for e in self.elements]
        )
        self._mats = mats
        if inner_product == "trace":
            self.inner_product = _trace_product
            # gram[i, j] = Tr(E_i E_j^H) as one matrix product
            flat = mats.reshape(self.dim, -1)
            self.gram = flat @ flat.conj().T
        else:
            self.inner_product = inner_product
            self.gram = np.zeros((self.dim, self.dim), dtype=np.complex128)
            for i in range(self.dim):
                for j in range(self.dim):
                    self.gram[i, j] = inner_product(self.elements[i], self.elements[j])

    def decompose(self, obj) -> np.ndarray:
        """Coefficients c with obj = sum_i c_i E_i."""
        m = np.asarray(getattr(obj, "matrix", obj), dtype=np.complex128)
        if self.inner_product is _trace_product:
            rhs = self._mats.reshape(self.dim, -1) @ m.reshape(-1).conj()
        else:
            rhs = np.array(
                [self.inner_product(e, obj) for e in self.elements],
                dtype=np.complex128,
            )
        return np.conj(np.linalg.solve(self.gram, rhs))

    def decompose_batch(self, mats_batch) -> np.ndarray:
        """Decompose a stack of matrices (k, d, d) in one Gram solve: the
        same as stacking `decompose` over the batch, with the Gram matrix
        factorized once."""
        mats_batch = np.asarray(mats_batch, dtype=np.complex128)
        if self.inner_product is not _trace_product:
            return np.stack([self.decompose(m) for m in mats_batch])
        rhs = self._mats.reshape(self.dim, -1) @ mats_batch.reshape(
            mats_batch.shape[0], -1
        ).conj().T
        return np.conj(np.linalg.solve(self.gram, rhs)).T

    def compose(self, vector):
        """Reconstruct an object from decomposition coefficients."""
        out = self.elements[0] * vector[0]
        for e, c in zip(self.elements[1:], vector[1:]):
            out = out + e * c
        return out

    def __repr__(self):
        return "Basis object\n" + repr(self.elements)
