"""Functional core of quantum state tomography (port of
quantpy_tpu/tomography/state_core.py, the main-path subset).

Batch-first functions on tensors. Each follows the dtype and device of its
main tensor argument (`counts`, or `bloch` for simulation); numpy inputs
get the port's default dtype and device (see `config`).

Shape conventions:
- povm_matrix: (m, p, D) real, D = 4^n — bloch rows
- n_measurements: (m,) shots per POVM
- counts / results: (..., m, p) real
- bloch: (..., D) real
"""

from __future__ import annotations

import math

import torch

from ..config import as_real
from ..ops import kernels
from ..ops.paulis import PTM_MAX_QUBITS, bloch_to_matrix, matrix_to_bloch, n_qubits_from_dim
from ..ops.sampling import sample_multinomial

__all__ = [
    "weighted_povm_flat",
    "experiment_probabilities",
    "simulate_experiment",
    "estimate_lin",
    "make_feasible_bloch",
    "estimate_mle_rhor",
    "estimate",
]


def _n_qubits_of_povm(povm_matrix) -> int:
    return n_qubits_from_dim(int(round(math.sqrt(povm_matrix.shape[-1]))))


def weighted_povm_flat(povm_matrix, n_measurements):
    """Flatten (m, p, D) -> (m*p, D) with the rows of POVM m scaled by
    n_m / sum(n)."""
    povm_matrix = as_real(povm_matrix)
    w = as_real(n_measurements, like=povm_matrix)
    w = w / w.sum()
    return (povm_matrix * w[:, None, None]).reshape(-1, povm_matrix.shape[-1])


def experiment_probabilities(povm_matrix, bloch):
    """Outcome probabilities p[..., m, o] = 2^n (povm . bloch), clipped to
    [0, 1]."""
    bloch = as_real(bloch)
    povm_matrix = as_real(povm_matrix, like=bloch)
    dim = math.sqrt(povm_matrix.shape[-1])
    probs = torch.einsum("mod,...d->...mo", povm_matrix, bloch) * dim
    return probs.clamp(0.0, 1.0)


def simulate_experiment(generator, povm_matrix, bloch, n_measurements):
    """Draw multinomial outcome counts for one state or a batch of states.

    Returns counts of shape (batch..., m, p) on the device of `bloch`;
    `generator` must live there too.
    """
    probs = experiment_probabilities(povm_matrix, bloch)
    n = as_real(n_measurements, like=probs).expand(probs.shape[:-1])
    return sample_multinomial(generator, n, probs)


def make_feasible_bloch(bloch, n_qubits: int):
    """Project onto physical states: clip the eigenvalues at 1e-15 and
    renormalize the trace. Batched; real in, real out."""
    rho = bloch_to_matrix(bloch, n_qubits)
    evals, evecs = torch.linalg.eigh(rho)
    evals = evals.clamp(min=1e-15)
    evals = evals / evals.sum(-1, keepdim=True)
    rho = (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)
    return matrix_to_bloch(rho)


def _frequencies(counts):
    freq = counts.reshape(tuple(counts.shape[:-2]) + (-1,))
    return freq / freq.sum(-1, keepdim=True)


def estimate_lin(counts, povm_matrix, n_measurements, physical: bool = True):
    """Linear-inversion estimate with a Gram solve, batched over the
    leading axes of `counts`. Returns bloch vectors (..., D)."""
    counts = as_real(counts)
    n_qubits = _n_qubits_of_povm(povm_matrix)
    a = weighted_povm_flat(as_real(povm_matrix, like=counts), n_measurements)
    freq = _frequencies(counts)
    gram = a.T @ a
    rhs = freq @ a
    dim2 = a.shape[-1]
    # one factorization of the Gram matrix for every right-hand side
    sol = torch.linalg.solve(gram, rhs.reshape(-1, dim2).T).T
    bloch = sol.reshape(rhs.shape) / (2**n_qubits)
    if physical:
        bloch = make_feasible_bloch(bloch, n_qubits)
    return bloch


def estimate_mle_rhor(
    counts,
    povm_matrix,
    n_measurements,
    init_bloch=None,
    max_iter: int = 200,
    tol: float = 1e-10,
):
    """Maximum-likelihood estimate via the RrhoR fixed-point iteration.

    rho_{t+1} = N[ R(rho_t) rho_t R(rho_t) ],  R(rho) = sum_j (f_j / p_j) E_j

    Batched over the leading axes of `counts`. The start is mixed 5% toward
    the fully mixed state, because RrhoR preserves the kernel of rho.

    On CUDA tensors the iterations run in the fused kernel
    (`kernels.rhor_mle`) for exactly `max_iter` iterations, and `tol` is
    ignored: the fixed point is stationary, so extra iterations are
    harmless. On CPU tensors the plain loop stops once max |bloch change|
    over the batch is not above `tol`, or after `max_iter` iterations.
    """
    counts = as_real(counts)
    n_qubits = _n_qubits_of_povm(povm_matrix)
    if n_qubits > PTM_MAX_QUBITS:
        raise NotImplementedError(
            f"RrhoR MLE above {PTM_MAX_QUBITS} qubits needs the kron-factored "
            "path, not ported yet (ROADMAP A9)"
        )
    dim = 2**n_qubits
    a2 = weighted_povm_flat(as_real(povm_matrix, like=counts), n_measurements) * dim
    freq = _frequencies(counts)
    if init_bloch is None:
        init_bloch = estimate_lin(counts, povm_matrix, n_measurements, physical=True)
    init_bloch = as_real(init_bloch, like=counts)
    mixed = torch.zeros_like(init_bloch)
    mixed[..., 0] = 1.0 / dim
    bloch0 = 0.95 * init_bloch + 0.05 * mixed

    if counts.device.type == "cuda":
        dim2 = a2.shape[-1]
        out = kernels.rhor_mle(
            freq.reshape(-1, freq.shape[-1]).contiguous(),
            bloch0.reshape(-1, dim2).contiguous(),
            a2.contiguous(),
            n_iter=int(max_iter),
        )
        return out.reshape(bloch0.shape)
    return kernels.rhor_mle_reference(freq, bloch0, a2, int(max_iter), tol=tol)


def estimate(
    counts,
    povm_matrix,
    n_measurements,
    method: str = "lin",
    physical: bool = True,
    init: str = "lin",
    max_iter: int = 100,
    tol: float = 1e-3,
):
    """Dispatching estimator, batched over the leading axes of `counts`:
    'lin' (linear inversion) or 'mle-rhor' (RrhoR fixed-point MLE). Returns
    bloch vectors."""
    if method == "lin":
        return estimate_lin(counts, povm_matrix, n_measurements, physical=physical)
    if method in ("mle", "mle-constr"):
        raise NotImplementedError(
            f"method {method!r} (Cholesky-parametrized LBFGS MLE) is not ported "
            "yet (ROADMAP A7); use 'mle-rhor'"
        )
    if method != "mle-rhor":
        raise ValueError("Invalid value for argument `method`")
    counts = as_real(counts)
    if init == "mixed":
        n_qubits = _n_qubits_of_povm(povm_matrix)
        init_bloch = counts.new_zeros(tuple(counts.shape[:-2]) + (povm_matrix.shape[-1],))
        init_bloch[..., 0] = 1.0 / (2**n_qubits)
    elif init == "lin":
        init_bloch = None
    else:
        raise ValueError("Invalid value for argument `init`")
    # the stop tolerance is floored at the working precision
    rhor_tol = max(float(torch.finfo(counts.dtype).eps) * 10, tol * 1e-3)
    return estimate_mle_rhor(
        counts, povm_matrix, n_measurements, init_bloch, max_iter, rhor_tol
    )
