"""Plain reference of the bootstrapped process interval.

Choi matrices C = sum_ab c[a, b] P_a (x) P_b (input factor first,
Tr_out C = I), the SIC input states, a channel's action on them, linear
inversion of the per-input-state frequencies, and the CPTP projection by
Dykstra's alternating projections: onto trace preserving maps, and onto
completely positive ones by eigendecomposition.
"""

from __future__ import annotations

import numpy as np
import torch

from .paulis import bloch_to_matrix, cmatmul, matrix_to_bloch, transpose_signs
from .state import frequencies

#: eigenvalue floor of the CP projection by eigendecomposition
CP_FLOOR = 1e-12

# the single-qubit SIC states, the corners of a regular tetrahedron in the
# Bloch ball, as bloch rows of unit trace
_S = 1 / np.sqrt(3)
_SIC_1 = np.array([[1.0, _S, _S, _S], [1.0, _S, -_S, -_S], [1.0, -_S, _S, -_S],
                   [1.0, -_S, -_S, _S]]) / 2


def sic_inputs(n: int) -> np.ndarray:
    """(4^n, 4^n) bloch vectors of the n-qubit SIC input states, products of
    single-qubit ones (np.kron order)."""
    out = _SIC_1
    for _ in range(n - 1):
        out = np.kron(out, _SIC_1)
    return out


def depolarized(inputs: np.ndarray, p: float) -> np.ndarray:
    """Bloch vectors of rho -> p tr(rho) I / d + (1 - p) rho."""
    out = (1.0 - p) * inputs
    out[..., 0] += p * inputs[..., 0]
    return out


def channel_outputs(choi: np.ndarray, inputs: np.ndarray, n: int) -> np.ndarray:
    """Bloch vectors (S, 4^n) of the channel with Choi bloch vector `choi`
    applied to `inputs`: Phi(rho) = Tr_in[(rho^T (x) I) C], so with
    rho^T = sum_a s_a r_a P_a and Tr(P_a P_x) = 2^n delta_ax,
    out[b] = 2^n sum_a s_a r_a c[a, b]."""
    c = np.asarray(choi, dtype=np.float64).reshape(4**n, 4**n)
    return 2**n * (inputs * transpose_signs(n)) @ c


def lifp(counts: torch.Tensor, inputs: np.ndarray, w: torch.Tensor, n: int) -> torch.Tensor:
    """Choi bloch vectors (..., 16^n) by least squares: the frequencies of
    input state s are f_s = 4^n W (B^T c)... per state, so
    c = (B^T B)^-1 B^T F W (W^T W)^-1 / 4^n with B the transposed inputs."""
    b = torch.as_tensor(inputs * transpose_signs(n), dtype=w.dtype, device=w.device)
    f = frequencies(counts)  # (..., S, K)
    left = torch.linalg.solve(b.T @ b, b.T)
    right = torch.linalg.solve(w.T @ w, w.T).T
    c = left @ (f @ right) / 4**n
    return c.reshape(tuple(c.shape[:-2]) + (-1,))


def tp_project(c: torch.Tensor, n: int) -> torch.Tensor:
    """Orthogonal projection of Choi matrices onto Tr_out C = I."""
    d = 2**n
    c4 = c.reshape(tuple(c.shape[:-2]) + (d, d, d, d))
    tr_out = torch.diagonal(c4, dim1=-3, dim2=-1).sum(-1)
    eye = torch.eye(d, dtype=c.dtype, device=c.device)
    corr = (eye - tr_out) / d
    return (c4 + corr[..., :, None, :, None] * eye[None, :, None, :]).reshape(c.shape)


def cp_project_eigh(a: torch.Tensor) -> torch.Tensor:
    """PSD projection by eigendecomposition, eigenvalues floored at CP_FLOOR."""
    evals, vecs = torch.linalg.eigh(a)
    evals = evals.clamp(min=CP_FLOOR)
    return cmatmul(vecs * evals[..., None, :].to(vecs.dtype), vecs.conj().transpose(-1, -2))


def dykstra_step(x, p, q, n: int, cp):
    """One Dykstra iteration onto TP, then CP:
    y = P_TP(x + p), p <- x + p - y, x <- P_CP(y + q), q <- y + q - x;
    with the squared change of both corrections in bloch units."""
    s = x + p
    y = tp_project(s, n)
    p_new = s - y
    t = y + q
    x = cp(t)
    q_new = t - x
    crit = ((p_new - p).abs() ** 2).sum((-2, -1)) + ((q_new - q).abs() ** 2).sum((-2, -1))
    return x, p_new, q_new, crit / 4**n


def dykstra(c: torch.Tensor, n: int, cp, max_iter: int, tol: float | None = None,
            around_stop: bool = False):
    """Dykstra's projections of Choi matrices: `max_iter` iterations, or
    fewer once the criterion, largest over the batch, is not above `tol`.
    Returns (matrices, iterations run); with `around_stop`, the matrices
    one iteration before, at and after the stop, since a run in another
    precision may cross `tol` one step apart."""
    x, p, q = c, torch.zeros_like(c), torch.zeros_like(c)
    prev, it = x, max_iter
    for k in range(1, max_iter + 1):
        prev = x
        x, p, q, crit = dykstra_step(x, p, q, n, cp)
        if tol is not None and not float(crit.max()) > tol:
            it = k
            break
    if around_stop:
        return [prev, x, dykstra_step(x, p, q, n, cp)[0]], it
    return x, it


def choi_to_matrix(c: torch.Tensor, n: int) -> torch.Tensor:
    return bloch_to_matrix(c, 2 * n)


def matrix_to_choi(m: torch.Tensor, n: int) -> torch.Tensor:
    return matrix_to_bloch(m, 2 * n)
