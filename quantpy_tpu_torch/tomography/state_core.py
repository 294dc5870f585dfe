"""Functional core of quantum state tomography (port of
quantpy_tpu/tomography/state_core.py).

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
from ..ops.cholesky import matrix_to_real_tril_vec, real_tril_vec_to_matrix
from ..ops.lbfgs import lbfgs_minimize
from ..ops.paulis import PTM_MAX_QUBITS, bloch_to_matrix, matrix_to_bloch, n_qubits_from_dim
from ..ops.sampling import sample_multinomial

__all__ = [
    "weighted_povm_flat",
    "experiment_probabilities",
    "simulate_experiment",
    "estimate_lin",
    "make_feasible_bloch",
    "nll_bloch",
    "nll_tril",
    "estimate_mle_chol",
    "estimate_mle_rhor",
    "estimate",
]

_NLL_EPS = 1e-10  # probability floor in the log


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


def nll_bloch(bloch, povm_flat_w, frequencies, n_qubits: int):
    """Negative log-likelihood of bloch vectors (..., D) given the weighted
    POVM rows (K, D) and count fractions (..., K)."""
    probs = bloch @ povm_flat_w.T * (2**n_qubits)
    return -(frequencies * torch.log(probs + _NLL_EPS)).sum(-1)


def _unit_trace_bloch(matrix):
    """Bloch vectors (..., 4^n) of matrices (..., 2^n, 2^n) divided by their
    traces."""
    tr = matrix.diagonal(dim1=-2, dim2=-1).real.sum(-1)
    return matrix_to_bloch(matrix) / tr[..., None]


def nll_tril(tril_vec, povm_flat_w, frequencies, n_qubits: int):
    """NLL of Cholesky parameter vectors (..., 4^n): rho = L L^H / tr.
    Differentiable by autograd."""
    rho = real_tril_vec_to_matrix(tril_vec, 2**n_qubits)
    return nll_bloch(_unit_trace_bloch(rho), povm_flat_w, frequencies, n_qubits)


def _mixed_start(init_bloch, dim: int, weight: float):
    """`init_bloch` mixed the fraction `weight` toward I/dim."""
    mixed = torch.zeros_like(init_bloch)
    mixed[..., 0] = 1.0 / dim
    return (1.0 - weight) * init_bloch + weight * mixed


def estimate_mle_chol(
    counts,
    povm_matrix,
    n_measurements,
    init_bloch=None,
    max_iter: int = 100,
    tol: float = 1e-6,
):
    """Cholesky-parametrized MLE by batched L-BFGS with autograd gradients.

    Batched over the leading axes of `counts`. The start is the lin
    estimate (or `init_bloch`) mixed 1% toward I/d, so that its Cholesky
    factor exists. Each resample stops on its own once the norm of its
    gradient is not above `tol`, or after `max_iter` iterations
    (`ops.lbfgs`). Returns the bloch vectors of the trace-normalized
    estimates.
    """
    counts = as_real(counts)
    n_qubits = _n_qubits_of_povm(povm_matrix)
    dim = 2**n_qubits
    a = weighted_povm_flat(as_real(povm_matrix, like=counts), n_measurements)
    freq = _frequencies(counts)
    if init_bloch is None:
        init_bloch = estimate_lin(counts, povm_matrix, n_measurements, physical=True)
    init_bloch = as_real(init_bloch, like=counts)
    x0 = matrix_to_real_tril_vec(bloch_to_matrix(_mixed_start(init_bloch, dim, 0.01), n_qubits))
    batch_shape = tuple(freq.shape[:-1])
    freq_b = freq.reshape(-1, freq.shape[-1])
    x = lbfgs_minimize(
        lambda v: nll_tril(v, a, freq_b, n_qubits),
        x0.reshape(-1, x0.shape[-1]),
        max_iter=max_iter,
        tol=tol,
    )
    bloch = _unit_trace_bloch(real_tril_vec_to_matrix(x, dim))
    return bloch.reshape(batch_shape + (dim * dim,))


def _use_rhor_kernel(counts, bloch0) -> bool:
    """Whether `estimate_mle_rhor` runs the fused kernel `kernels.rhor_mle`
    for a fixed count of iterations: only for a batch of starts (B, D) of
    n <= PTM_MAX_QUBITS qubits on the card in float32, the JAX package's
    rule for its Pallas kernel without the TPU's tiling test. Every other
    call runs the plain loop, which stops at `tol`."""
    return (
        counts.device.type == "cuda"
        and counts.dtype == torch.float32
        and bloch0.ndim == 2
        and bloch0.shape[-1] <= 4**PTM_MAX_QUBITS
    )


def _rhor_update(bloch, r_bloch, n_qubits: int):
    """One RrhoR step from bloch vectors of rho and R, through the factored
    transforms: N[R rho R] as bloch vectors."""
    r = bloch_to_matrix(r_bloch, n_qubits)
    return _unit_trace_bloch(r @ bloch_to_matrix(bloch, n_qubits) @ r)


def _rhor_iterate(r_of, bloch0, n_qubits: int, max_iter: int, tol: float):
    """The RrhoR fixed point from `bloch0` with `r_of(bloch)` the bloch
    vectors of R: at most `max_iter` steps, stopping once max |bloch
    change| over the whole batch is not above `tol`."""
    bloch = bloch0
    for _ in range(int(max_iter)):
        new = _rhor_update(bloch, r_of(bloch), n_qubits)
        delta = float((new - bloch).abs().max())
        bloch = new
        if not delta > tol:
            break
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

    A batch of starts (B, D) in float32 on the card runs in the fused
    kernel (`kernels.rhor_mle`) for exactly `max_iter` iterations: the
    fixed point is stationary, so extra iterations are harmless. Every
    other call (float64, a single experiment, the CPU, more than
    PTM_MAX_QUBITS qubits) runs the plain loop on the device of `counts`,
    which stops once max |bloch change| over the batch is not above `tol`,
    or after `max_iter` iterations. Above PTM_MAX_QUBITS that loop maps
    through the factored transforms instead of the dense Pauli transfer
    matrix.
    """
    counts = as_real(counts)
    n_qubits = _n_qubits_of_povm(povm_matrix)
    dim = 2**n_qubits
    a2 = weighted_povm_flat(as_real(povm_matrix, like=counts), n_measurements) * dim
    freq = _frequencies(counts)
    if init_bloch is None:
        init_bloch = estimate_lin(counts, povm_matrix, n_measurements, physical=True)
    bloch0 = _mixed_start(as_real(init_bloch, like=counts), dim, 0.05)

    if n_qubits > PTM_MAX_QUBITS:
        def r_of(bloch):
            return (freq / (bloch @ a2.T).clamp(min=_NLL_EPS)) @ a2

        return _rhor_iterate(r_of, bloch0, n_qubits, max_iter, tol)
    if _use_rhor_kernel(counts, bloch0):
        return kernels.rhor_mle(
            freq.reshape(-1, freq.shape[-1]).contiguous(),
            bloch0.contiguous(),
            a2.contiguous(),
            n_iter=int(max_iter),
        )
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
    'lin' (linear inversion), 'mle' and 'mle-constr' (Cholesky-LBFGS MLE)
    or 'mle-rhor' (RrhoR fixed-point MLE). Returns bloch vectors.

    'mle-constr' is the same estimator as 'mle': the reference's
    trace-constrained variant adds a unit-trace constraint that the
    trace-normalized Cholesky estimate meets either way.
    """
    if method == "lin":
        return estimate_lin(counts, povm_matrix, n_measurements, physical=physical)
    if method not in ("mle", "mle-constr", "mle-rhor"):
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
    if method in ("mle", "mle-constr"):
        # the reference's tol=1e-3 is on scipy BFGS's gradient scale
        return estimate_mle_chol(
            counts, povm_matrix, n_measurements, init_bloch, max_iter, tol * 1e-3
        )
    # the stop tolerance is floored at the working precision
    rhor_tol = max(float(torch.finfo(counts.dtype).eps) * 10, tol * 1e-3)
    return estimate_mle_rhor(
        counts, povm_matrix, n_measurements, init_bloch, max_iter, rhor_tol
    )
