"""POVM construction (port of quantpy_tpu/measurements.py; numpy only).

A POVM matrix is a real 3-D array (n_povms, n_outcomes, 4^n) of
bloch-vector rows; the rows of each POVM sum to the identity's bloch
vector.

Presets (identical numerics to the reference):
- 'proj'     : all 6 Pauli eigenstates as one POVM, rows /6
- 'proj-set' : X, Y, Z projective measurements as 3 separate POVMs, rows /2
- 'proj4'    : 4-outcome POVM {x+, y+, z+, z-}, rows /4
- 'sic'      : tetrahedral SIC POVM, rows /4
Arrays: per-qubit (*, 4) or (*, *, 4) matrices are tensored to n qubits via
iterated np.kron; full-system (*, 4^n) matrices pass through.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_measurement_matrix", "POVM_PRESETS"]


def _single_qubit_preset(name: str) -> np.ndarray:
    xp = np.array([1.0, 1, 0, 0])
    xm = np.array([1.0, -1, 0, 0])
    yp = np.array([1.0, 0, 1, 0])
    ym = np.array([1.0, 0, -1, 0])
    zp = np.array([1.0, 0, 0, 1])
    zm = np.array([1.0, 0, 0, -1])
    if name == "proj":
        return np.stack([xp, xm, yp, ym, zp, zm])[None, :, :] / 6
    if name == "proj-set":
        return np.stack([[xp, xm], [yp, ym], [zp, zm]]) / 2
    if name == "proj4":
        return np.stack([xp, yp, zp, zm])[None, :, :] / 4
    if name == "sic":
        s = 1 / np.sqrt(3)
        tetra = np.array(
            [
                [1.0, s, s, s],
                [1.0, s, -s, -s],
                [1.0, -s, s, -s],
                [1.0, -s, -s, s],
            ]
        )
        return tetra[None, :, :] / 4
    raise ValueError("Incorrect string shortcut for argument `povm`")


POVM_PRESETS = ("proj", "proj-set", "proj4", "sic")


def generate_measurement_matrix(povm="proj", n_qubits: int = 1) -> np.ndarray:
    """Build the (n_povms, n_outcomes, 4^n) POVM matrix.

    Parameters mirror reference quantpy/measurements.py:4-35; see the module
    docstring for accepted forms.
    """
    if isinstance(povm, str):
        povm_1 = _single_qubit_preset(povm)
    else:
        povm = np.asarray(povm)
        if povm.shape[-1] == 4 and n_qubits >= 1:
            povm_1 = povm if povm.ndim == 3 else povm[None, :, :]
        elif povm.shape[-1] == 4**n_qubits:
            return povm if povm.ndim == 3 else povm[None, :, :]
        else:
            raise ValueError("Incorrect POVM matrix")
    out = povm_1
    for _ in range(n_qubits - 1):
        out = np.kron(out, povm_1)
    return out
