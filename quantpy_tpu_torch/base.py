"""Shared algebra for quantum objects (port of quantpy_tpu/base.py).

Objects are lightweight host handles over numpy arrays: a single state
matrix is O(4^n) numbers of host work. Batched device computation goes
through the functional layer (`ops`, `tomography`), to which objects
export real tensors (`Qobj.bloch_tensor`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from copy import deepcopy

import numpy as np

_SCALARS = (int, float, complex, np.integer, np.floating, np.complexfloating)


class BaseQuantum(ABC):
    """Mixin providing matrix algebra via the subclass's `matrix` property.

    Every operation returns a new instance of the same class, mirroring
    reference quantpy/base_quantum.py:14-89.
    """

    @abstractmethod
    def __repr__(self):  # pragma: no cover - subclass responsibility
        ...

    @property
    def T(self):
        """Transpose."""
        return self.__class__(self.matrix.T)

    @property
    def H(self):
        """Conjugate transpose (adjoint)."""
        return self.__class__(self.matrix.conj().T)

    def conj(self):
        """Elementwise complex conjugate."""
        return self.__class__(self.matrix.conj())

    def copy(self):
        """Deep copy of this instance."""
        return deepcopy(self)

    def kron(self, other):
        """Kronecker (tensor) product with another instance."""
        return self.__class__(np.kron(self.matrix, other.matrix))

    def __eq__(self, other):
        return np.array_equal(self.matrix, other.matrix)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __neg__(self):
        return self.__class__(-self.matrix)

    def __matmul__(self, other):
        return self.__class__(self.matrix @ other.matrix)

    def __add__(self, other):
        return self.__class__(self.matrix + other.matrix)

    def __sub__(self, other):
        return self.__class__(self.matrix - other.matrix)

    def __mul__(self, scalar):
        if not isinstance(scalar, _SCALARS):
            raise ValueError("Only multiplication by a scalar is allowed")
        return self.__class__(self.matrix * scalar)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        if not isinstance(scalar, _SCALARS):
            raise ValueError("Only division by a scalar is allowed")
        return self.__class__(self.matrix / scalar)

    def __iadd__(self, other):
        self.matrix = self.matrix + other.matrix
        return self

    def __isub__(self, other):
        self.matrix = self.matrix - other.matrix
        return self

    def __imul__(self, scalar):
        if not isinstance(scalar, _SCALARS):
            raise ValueError("Only multiplication by a scalar is allowed")
        self.matrix = self.matrix * scalar
        return self

    def __itruediv__(self, scalar):
        if not isinstance(scalar, _SCALARS):
            raise ValueError("Only division by a scalar is allowed")
        self.matrix = self.matrix / scalar
        return self
