"""Plain reference of bootstrapped state tomography.

The design, the true state, the experiment's draw (NumPy, from the
benchmark's seed), linear inversion with the eigenvalue clip, the RrhoR
fixed point, the Hilbert-Schmidt distance and the interval's quantiles.
"""

from __future__ import annotations

import numpy as np
import torch

from .paulis import bloch_to_matrix, cmatmul, matrix_to_bloch

#: probability floor of RrhoR's ratio f / p, and the eigenvalue clip of lin
PROB_FLOOR = 1e-10
EIG_FLOOR = 1e-15
#: share of the fully mixed state in RrhoR's start
START_MIX = 0.05

# single-qubit projectors on the X, Y and Z eigenstates, as bloch rows
_PROJ_SET_1 = np.array(
    [
        [[1.0, 1, 0, 0], [1.0, -1, 0, 0]],
        [[1.0, 0, 1, 0], [1.0, 0, -1, 0]],
        [[1.0, 0, 0, 1], [1.0, 0, 0, -1]],
    ]
) / 2


def proj_set_povm(n: int) -> np.ndarray:
    """(3^n, 2^n, 4^n) bloch rows of the n-qubit Pauli projective
    measurements: every setting's 2^n outcome projectors."""
    out = _PROJ_SET_1
    for _ in range(n - 1):
        out = np.kron(out, _PROJ_SET_1)
    return out


def ghz_bloch(n: int) -> np.ndarray:
    """Bloch vector of (|0..0> + |1..1>) / sqrt(2)."""
    ket = np.zeros(2**n)
    ket[0] = ket[-1] = 1 / np.sqrt(2)
    rho = torch.as_tensor(np.outer(ket, ket), dtype=torch.complex128)
    return matrix_to_bloch(rho, n).numpy()


def probabilities(povm: np.ndarray, bloch: np.ndarray) -> np.ndarray:
    """Outcome probabilities (..., m, p) = 2^n <row, bloch>, clipped to [0, 1]
    and normalized per setting."""
    dim = np.sqrt(povm.shape[-1])
    p = np.clip(np.einsum("mod,...d->...mo", povm, bloch) * dim, 0.0, 1.0)
    return p / p.sum(-1, keepdims=True)


def draw_counts(rng: np.random.Generator, probs: np.ndarray, shots: int) -> np.ndarray:
    """Multinomial counts of `shots` per setting, as float64."""
    return rng.multinomial(shots, probs).astype(np.float64)


def design(povm: np.ndarray, shots, dtype, device) -> torch.Tensor:
    """(K, D) POVM rows weighted by each setting's share of the shots."""
    shots = np.broadcast_to(np.asarray(shots, dtype=np.float64), povm.shape[:1])
    w = (povm * (shots / shots.sum())[:, None, None]).reshape(-1, povm.shape[-1])
    return torch.as_tensor(w, dtype=dtype, device=device)


def frequencies(counts: torch.Tensor) -> torch.Tensor:
    """(..., m, p) counts -> (..., K) shares of all shots."""
    f = counts.reshape(tuple(counts.shape[:-2]) + (-1,))
    return f / f.sum(-1, keepdim=True)


def clip_to_state(bloch: torch.Tensor, n: int) -> torch.Tensor:
    """Eigenvalues clipped at EIG_FLOOR, trace renormalized to 1."""
    evals, vecs = torch.linalg.eigh(bloch_to_matrix(bloch, n))
    evals = evals.clamp(min=EIG_FLOOR)
    evals = evals / evals.sum(-1, keepdim=True)
    rho = cmatmul(vecs * evals[..., None, :].to(vecs.dtype), vecs.conj().transpose(-1, -2))
    return matrix_to_bloch(rho, n)


def lin(freq: torch.Tensor, w: torch.Tensor, n: int, physical: bool = True) -> torch.Tensor:
    """Least-squares inversion of f = 2^n W b through the normal equations."""
    rhs = freq @ w
    b = torch.linalg.solve(w.T @ w, rhs.reshape(-1, rhs.shape[-1]).T).T.reshape(rhs.shape)
    b = b / 2**n
    return clip_to_state(b, n) if physical else b


def rhor_step(b: torch.Tensor, freq: torch.Tensor, w2: torch.Tensor, n: int) -> torch.Tensor:
    """One RrhoR step: rho <- R rho R / tr, R = sum_k f_k / p_k E_k."""
    r = bloch_to_matrix((freq / (b @ w2.T).clamp(min=PROB_FLOOR)) @ w2, n)
    new = matrix_to_bloch(cmatmul(cmatmul(r, bloch_to_matrix(b, n)), r), n)
    return new / (2**n * new[..., :1])


def rhor(freq: torch.Tensor, start: torch.Tensor, w: torch.Tensor, n: int, n_iter: int,
         tol: float | None = None, around_stop: bool = False):
    """RrhoR from `start` mixed START_MIX toward I / 2^n: `n_iter` steps, or
    fewer once the largest change of any bloch entry of the batch is not
    above `tol`. With `around_stop`, the iterates one before, at and one
    after the stop, since a run in another precision may cross `tol` one
    step apart."""
    dim = 2**n
    w2 = w * dim
    mixed = torch.zeros_like(start)
    mixed[..., 0] = 1.0 / dim
    b = prev = (1.0 - START_MIX) * start + START_MIX * mixed
    for _ in range(n_iter):
        new = rhor_step(b, freq, w2, n)
        change = (new - b).abs().max()
        prev, b = b, new
        if tol is not None and not float(change) > tol:
            break
    if around_stop:
        return [prev, b, rhor_step(b, freq, w2, n)]
    return b


def estimate(freq, w, n, method: str, max_iter: int = 0, tol: float | None = None,
             around_stop: bool = False):
    """'lin' (eigenvalue-clipped) or 'mle-rhor' (RrhoR from the clipped lin);
    `around_stop` as in `rhor` (lin has one candidate)."""
    start = lin(freq, w, n, physical=True)
    if method == "lin":
        return [start] if around_stop else start
    if method == "mle-rhor":
        return rhor(freq, start, w, n, max_iter, tol, around_stop)
    raise ValueError(f"no reference for method {method!r}")


def hs_distance(blochs: torch.Tensor, center: torch.Tensor, n: int) -> torch.Tensor:
    """Hilbert-Schmidt distance ||A - B||_F / sqrt(2) through bloch space."""
    return torch.sqrt(2**n * ((blochs - center) ** 2).sum(-1) / 2)


def quantiles(sorted_distances: np.ndarray, levels) -> np.ndarray:
    """The interval's map: linear interpolation of the sorted distances at
    confidence levels spread evenly over [0, 1]."""
    grid = np.linspace(0.0, 1.0, len(sorted_distances))
    return np.interp(np.asarray(levels, dtype=np.float64), grid, sorted_distances)
