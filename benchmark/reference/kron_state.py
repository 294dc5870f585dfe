"""Plain reference of bootstrapped state tomography on a product design,
one qubit at a time.

The design of Haffner et al., "Scalable multiparticle entanglement of
trapped ions", Nature 438, 643 (2005): every qubit measured in x, y or z
(3^n settings of 2^n outcomes each), a fixed number of repetitions per
setting, a maximum-likelihood reconstruction and Monte Carlo error bars,
that is a parametric bootstrap of the estimate. Here: the true state from
its ket (W or GHZ), the outcome probabilities, the experiment's draw
(NumPy, from a seed), linear inversion by the per-qubit Gram inverse, the
eigenvalue clip, the RrhoR fixed point, the Hilbert-Schmidt distance and
the interval's quantiles.

Every map runs as a chain of contractions of one qubit each with the
single-qubit block (3, 2, 4), in whatever dtype and on whatever device it
is handed: float64 for the reference, float32 with TF32 products for the
control. Products of complex matrices run through real products, so the
TF32 setting governs them too. Importing this module turns TF32 off, as
the program does; the control turns it on around its own run.

Departures from the published method:

- the truth is the ideal state of its ket: the paper's counts are not in
  the repository, so the experiment is drawn from the ideal W state;
- the estimate is RrhoR's fixed point, stopped after a fixed count of
  steps or once the largest change of any bloch entry over a batch is not
  above a tolerance, from the linear inversion clipped to a state and
  mixed 5% toward I / 2^n; the paper maximized the likelihood by its own
  iteration to convergence;
- the error bars are the Hilbert-Schmidt distances of re-estimates from
  counts drawn at the estimate, and their quantiles, not the spread of
  derived quantities (fidelities, entanglement witnesses) the paper gave.

Bloch vectors follow A = sum_a b_a P_a, b_a = Re Tr(P_a A) / 2^n, with the
Pauli order I, X, Y, Z per qubit and the first qubit most significant; the
outcomes of one setting run over (o_1, .., o_n), and the settings over
(m_1, .., m_n), the first qubit most significant.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: probability floor of RrhoR's ratio f / p, and the eigenvalue clip of lin
PROB_FLOOR = 1e-10
EIG_FLOOR = 1e-15
#: share of the fully mixed state in RrhoR's start
START_MIX = 0.05

PAULI = np.array(
    [[[1, 0], [0, 1]], [[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]]],
    dtype=np.complex128,
)
#: single-qubit projectors on the X, Y and Z eigenstates, as bloch rows:
#: (setting, outcome, Pauli)
PROJ_SET_1 = np.array(
    [
        [[1.0, 1, 0, 0], [1.0, -1, 0, 0]],
        [[1.0, 0, 1, 0], [1.0, 0, -1, 0]],
        [[1.0, 0, 0, 1], [1.0, 0, 0, -1]],
    ]
) / 2
COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def w_ket(n: int) -> np.ndarray:
    """(|10..0> + |01..0> + .. + |0..01>) / sqrt(n)."""
    ket = np.zeros(2**n)
    ket[2 ** np.arange(n)] = 1 / np.sqrt(n)
    return ket


def ghz_ket(n: int) -> np.ndarray:
    """(|0..0> + |1..1>) / sqrt(2)."""
    ket = np.zeros(2**n)
    ket[0] = ket[-1] = 1 / np.sqrt(2)
    return ket


def bloch_of_ket(ket: np.ndarray) -> np.ndarray:
    """Bloch vector (4^n,) of the pure state |ket><ket|, float64."""
    n = int(round(np.log2(len(ket))))
    rho = torch.as_tensor(np.outer(ket, np.conj(ket)), dtype=torch.complex128)
    return matrix_to_bloch(rho, n).numpy()


def bloch_to_matrix(b: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 4^n) real -> (..., 2^n, 2^n) complex."""
    lead = tuple(b.shape[:-1])
    k = len(lead)
    x = b.reshape(lead + (4,) * n).to(COMPLEX_OF[b.dtype])
    p = torch.as_tensor(PAULI, dtype=x.dtype, device=x.device)
    for _ in range(n):
        # the next qubit's Pauli axis contracted; its (row, col) pair goes last
        x = torch.tensordot(x, p, dims=([k], [0]))
    perm = list(range(k)) + [k + 2 * q for q in range(n)] + [k + 2 * q + 1 for q in range(n)]
    return x.permute(perm).reshape(lead + (2**n, 2**n))


def matrix_to_bloch(a: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2^n, 2^n) -> (..., 4^n) real: Re Tr(P_a A) / 2^n."""
    lead = tuple(a.shape[:-2])
    k = len(lead)
    x = a.reshape(lead + (2,) * (2 * n))
    # Tr(P A) = sum_{r,c} P[c, r] A[r, c]
    pt = torch.as_tensor(PAULI, dtype=a.dtype, device=a.device).transpose(1, 2)
    for step in range(n):
        x = torch.tensordot(x, pt, dims=([k, k + n - step], [1, 2]))
    return x.reshape(lead + (4**n,)).real / 2**n


def cmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex product through real products (governed by the TF32 setting)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


def _block(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(PROJ_SET_1, dtype=like.dtype, device=like.device)


def forward(b: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 4^n) -> (..., 3^n, 2^n): <row, b> for every setting's outcome
    rows, the kron of the single-qubit rows (no scaling)."""
    lead = tuple(b.shape[:-1])
    k = len(lead)
    a1 = _block(b)
    x = b.reshape(lead + (4,) * n)
    for _ in range(n):
        # the next qubit's Pauli axis contracted; its (setting, outcome) pair goes last
        x = torch.tensordot(x, a1, dims=([k], [2]))
    perm = list(range(k)) + [k + 2 * q for q in range(n)] + [k + 2 * q + 1 for q in range(n)]
    return x.permute(perm).reshape(lead + (3**n, 2**n))


def adjoint(c: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 3^n, 2^n) -> (..., 4^n): the transpose of `forward`."""
    lead = tuple(c.shape[:-2])
    k = len(lead)
    a1 = _block(c)
    x = c.reshape(lead + (3,) * n + (2,) * n)
    for step in range(n):
        # the next qubit's (setting, outcome) pair contracted; its Pauli axis goes last
        x = torch.tensordot(x, a1, dims=([k, k + n - step], [0, 1]))
    return x.reshape(lead + (4**n,))


def probabilities(b: torch.Tensor, n: int) -> torch.Tensor:
    """Outcome probabilities (..., 3^n, 2^n) = 2^n <row, b>, clipped to
    [0, 1] and normalized per setting."""
    p = (forward(b, n) * 2**n).clamp(0.0, 1.0)
    return p / p.sum(-1, keepdim=True)


def draw_counts(rng: np.random.Generator, probs: np.ndarray, shots: int) -> np.ndarray:
    """Multinomial counts of `shots` per setting, as float64."""
    return rng.multinomial(shots, probs).astype(np.float64)


def frequencies(counts: torch.Tensor) -> torch.Tensor:
    """(..., 3^n, 2^n) counts -> shares of all shots, same shape."""
    return counts / counts.sum((-2, -1), keepdim=True)


def clip_to_state(b: torch.Tensor, n: int) -> torch.Tensor:
    """Eigenvalues clipped at EIG_FLOOR, trace renormalized to 1."""
    evals, vecs = torch.linalg.eigh(bloch_to_matrix(b, n))
    evals = evals.clamp(min=EIG_FLOOR)
    evals = evals / evals.sum(-1, keepdim=True)
    rho = cmatmul(vecs * evals[..., None, :].to(vecs.dtype), vecs.conj().transpose(-1, -2))
    return matrix_to_bloch(rho, n)


def lin(freq: torch.Tensor, n: int, physical: bool = True) -> torch.Tensor:
    """Least squares of f = 2^n W b with W the rows over the 3^n settings:
    b = 3^n / 2^n (kron G1)^-1 (kron A1)^T f, G1 = A1^T A1 of the flattened
    single-qubit rows, its inverse applied to one qubit at a time."""
    a1 = _block(freq).reshape(6, 4)
    g1_inv = torch.linalg.inv(a1.T @ a1)
    x = adjoint(freq, n)
    lead = tuple(x.shape[:-1])
    x = x.reshape(lead + (4,) * n)
    for _ in range(n):
        x = torch.tensordot(x, g1_inv, dims=([len(lead)], [0]))
    b = x.reshape(lead + (4**n,)) * 3**n / 2**n
    return clip_to_state(b, n) if physical else b


def rhor_step(b: torch.Tensor, freq: torch.Tensor, n: int) -> torch.Tensor:
    """One RrhoR step: rho <- R rho R / tr, R = sum_k f_k / p_k E_k with the
    outcome effects E_k weighted 1 / 3^n, p_k = Tr(E_k rho)."""
    w = 2**n / 3**n
    p = (forward(b, n) * 2**n).clamp(0.0, 1.0) / 3**n
    r = bloch_to_matrix(adjoint(freq / p.clamp(min=PROB_FLOOR), n) * w, n)
    new = matrix_to_bloch(cmatmul(cmatmul(r, bloch_to_matrix(b, n)), r), n)
    return new / (2**n * new[..., :1])


def rhor(freq: torch.Tensor, start: torch.Tensor, n: int, n_iter: int, tol: float | None = None,
         around_stop: bool = False):
    """RrhoR from `start` mixed START_MIX toward I / 2^n: `n_iter` steps, or
    fewer once the largest change of any bloch entry of the batch is not
    above `tol`. With `around_stop`, the iterates one before, at and one
    after the stop, since a run in another precision may cross `tol` one
    step apart."""
    mixed = torch.zeros_like(start)
    mixed[..., 0] = 1.0 / 2**n
    b = prev = (1.0 - START_MIX) * start + START_MIX * mixed
    for _ in range(n_iter):
        new = rhor_step(b, freq, n)
        change = (new - b).abs().max()
        prev, b = b, new
        if tol is not None and not float(change) > tol:
            break
    if around_stop:
        return [prev, b, rhor_step(b, freq, n)]
    return b


def estimate(freq, n: int, method: str, max_iter: int = 0, tol: float | None = None,
             around_stop: bool = False):
    """'lin' (eigenvalue-clipped) or 'mle-rhor' (RrhoR from the clipped
    lin); `around_stop` as in `rhor` (lin has one candidate)."""
    start = lin(freq, n, physical=True)
    if method == "lin":
        return [start] if around_stop else start
    if method == "mle-rhor":
        return rhor(freq, start, n, max_iter, tol, around_stop)
    raise ValueError(f"no reference for method {method!r}")


def hs_distance(blochs: torch.Tensor, center: torch.Tensor, n: int) -> torch.Tensor:
    """Hilbert-Schmidt distance ||A - B||_F / sqrt(2) through bloch space."""
    return torch.sqrt(2**n * ((blochs - center) ** 2).sum(-1) / 2)


def quantiles(sorted_distances: np.ndarray, levels) -> np.ndarray:
    """The interval's map: linear interpolation of the sorted distances at
    confidence levels spread evenly over [0, 1]."""
    grid = np.linspace(0.0, 1.0, len(sorted_distances))
    return np.interp(np.asarray(levels, dtype=np.float64), grid, sorted_distances)
