"""Batched parametric bootstrap (port of
quantpy_tpu/tomography/bootstrap_core.py).

    counts  ~ Multinomial(povm, bloch_est)        # (B, m, p) in one draw
    blochs  = estimate(counts)                    # batched lin / RrhoR MLE
    dists   = dst(blochs, bloch_est)              # batched

Everything runs on the device of `bloch_est`, with randomness from the
explicit generator.
"""

from __future__ import annotations

import math

import torch

from ..config import as_real
from ..ops import geometry
from ..ops.cholesky import real_tril_vec_to_matrix
from ..ops.paulis import bloch_to_matrix, matrix_to_bloch
from . import state_core

__all__ = ["bootstrap_distances", "bootstrap_blochs", "tril_samples_distance"]


def _distance_batch(name: str, blochs, bloch_ref, n_qubits: int):
    """Batched distance between bloch-encoded states.

    The Hilbert-Schmidt distance stays in bloch space: Pauli orthogonality
    gives ||A - B||_F^2 = 2^n sum_i (a_i - b_i)^2. 'trace' and 'if' go
    through the matrices and `geometry`."""
    blochs = as_real(blochs)
    bloch_ref = as_real(bloch_ref, like=blochs)
    if name == "hs":
        diff = blochs - bloch_ref
        d = torch.sqrt((2**n_qubits) * (diff**2).sum(-1) / 2.0)
        return torch.where(d < geometry.SNAP_EPS, torch.zeros_like(d), d)
    rho_b = bloch_to_matrix(blochs, n_qubits)
    rho_r = bloch_to_matrix(bloch_ref, n_qubits)
    return geometry.resolve_distance(name)(rho_b, rho_r)


def tril_samples_distance(name: str, tril_vecs, bloch_ref, n_qubits: int):
    """Distances of Cholesky-parametrized samples (..., 4^n), each
    normalized to unit trace, to a reference state: the MHMC state
    interval's distances."""
    rho = real_tril_vec_to_matrix(as_real(tril_vecs), 2**n_qubits)
    tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
    return _distance_batch(name, matrix_to_bloch(rho) / tr[..., None], bloch_ref, n_qubits)


def bootstrap_blochs(
    generator,
    bloch_est,
    povm_matrix,
    n_measurements,
    n_points: int,
    method: str = "lin",
    max_iter: int = 100,
    physical: bool = True,
    init: str = "lin",
    tol: float = 1e-3,
):
    """Simulate `n_points` experiments from `bloch_est` (D,) and re-estimate
    each; returns the (n_points, D) estimate blochs."""
    bloch_est = as_real(bloch_est)
    povm_matrix = as_real(povm_matrix, like=bloch_est)
    blochs = bloch_est.expand((n_points,) + tuple(bloch_est.shape))
    counts = state_core.simulate_experiment(generator, povm_matrix, blochs, n_measurements)
    return state_core.estimate(
        counts, povm_matrix, n_measurements, method=method, max_iter=max_iter,
        physical=physical, init=init, tol=tol,
    )


def bootstrap_distances(
    generator,
    bloch_est,
    povm_matrix,
    n_measurements,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
    physical: bool = True,
    init: str = "lin",
    tol: float = 1e-3,
):
    """Simulate and re-estimate `n_points` experiments from `bloch_est` and
    return their UNSORTED distances (n_points,) to it. `physical`, `init`
    and `tol` are forwarded to the per-resample estimator."""
    bloch_est = as_real(bloch_est)
    n_qubits = int(round(math.log(bloch_est.shape[-1], 4)))
    est = bootstrap_blochs(
        generator, bloch_est, povm_matrix, n_measurements, n_points,
        method=method, max_iter=max_iter, physical=physical, init=init, tol=tol,
    )
    return _distance_batch(dst, est, bloch_est, n_qubits)
