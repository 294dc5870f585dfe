"""Kron-factored measurement paths: state tomography without materializing
the POVM (port of quantpy_tpu/tomography/kron_core.py).

For a product design (every preset, and any per-qubit block) the full
measurement matrix is a Kronecker power of one (m1, p1, 4) block: at 6
qubits proj-set is (729, 64, 4096), 1.5 GB in float64. This module never
forms it:

- the probabilities (kron A1) bloch run as a chain of two-operand
  contractions, one group of up to three qubits at a time (per-group
  factors, (27, 8, 64) for proj-set);
- the adjoint (kron A1)^T c is the mirrored chain;
- the Gram matrix factorizes, (kron A1)^T (kron A1) = kron(A1^T A1), so the
  linear inversion applies one inverse factor per group;
- RrhoR MLE runs the same two chains for its products.

The chains contract group 1 first, then group 2, and so on, in the order
of the JAX package's einsum subscripts. Each intermediate is then no
larger than the outcome counts themselves: at 11 qubits proj-set the
counts are 177,147 x 2,048 entries (1.45 GB in float32), and so is the
largest intermediate.

Only uniform shot counts per POVM keep the product structure; a
non-uniform design runs the dense path.

Functions follow the dtype and device of their main tensor argument;
numpy inputs get the port's defaults.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import as_real
from ..ops.cholesky import real_tril_vec_to_matrix
from ..ops.paulis import group_sizes
from ..ops.sampling import sample_multinomial
from ..utils import profiling
from .bootstrap_core import _distance_batch
from .state_core import (
    _NLL_EPS,
    _mixed_start,
    _rhor_iterate,
    _unit_trace_bloch,
    make_feasible_bloch,
)

__all__ = [
    "kron_probs",
    "kron_apply_adjoint",
    "kron_forward_flat",
    "kron_adjoint_flat",
    "kron_row_component",
    "kron_simulate",
    "kron_simulate_chunked",
    "kron_nll_tril",
    "kron_estimate_lin",
    "kron_estimate_mle_rhor",
    "kron_bootstrap_distances",
]

#: count entries per bootstrap chunk: resamples are drawn and estimated
#: in chunks of at most this many outcome counts
CHUNK_COUNT_ENTRIES = 1 << 25


def _grouped_factors(povm1, n_qubits: int):
    """Kron the per-qubit block into per-group factors (up to three qubits
    a group, as `group_sizes` splits them).

    Returns (groups, factors): the group sizes and the (m1^g, p1^g, 4^g)
    factors, in the dtype and on the device of `povm1`."""
    groups = group_sizes(n_qubits)
    factors = []
    for g in groups:
        f = povm1
        for _ in range(g - 1):
            f = torch.einsum("mpd,nqe->mnpqde", f, povm1).reshape(
                f.shape[0] * povm1.shape[0],
                f.shape[1] * povm1.shape[1],
                f.shape[2] * povm1.shape[2],
            )
        factors.append(f)
    return groups, factors


def _forward(povm1, n_qubits: int, bloch):
    """(kron povm1) bloch as (Z, M, P) for bloch (..., 4^n), Z the flattened
    batch."""
    groups, factors = _grouped_factors(povm1, n_qubits)
    return _forward_chain(factors, bloch.reshape((-1,) + tuple(4**g for g in groups)))


def _forward_chain(factors, x):
    """The forward chain through the per-group `factors` for x (Z, d_1, ..,
    d_k): (Z, M, P) with M = prod m_j, P = prod p_j. A factor may hold a
    slice of its outcomes p_j (the operator-sharded forward of
    `parallel.mesh`)."""
    k = len(factors)
    for f in factors:
        # (Z, d_j, .., d_k, m_1, p_1, .., m_{j-1}, p_{j-1}) -> d_j contracted,
        # (m_j, p_j) appended
        x = torch.tensordot(x, f, dims=([1], [2]))
    perm = [0] + [1 + 2 * j for j in range(k)] + [2 + 2 * j for j in range(k)]
    m_total = math.prod(f.shape[0] for f in factors)
    return x.permute(perm).reshape(x.shape[0], m_total, -1)


def _adjoint(povm1, n_qubits: int, c):
    """(kron povm1)^T c as (Z, 4^n) for c (..., M, P)."""
    _, factors = _grouped_factors(povm1, n_qubits)
    return _adjoint_chain(factors, c)


def _adjoint_chain(factors, c):
    """The adjoint chain through the per-group `factors` for c (..., M, P)
    in the factors' outcome sizes: (Z, 4^n)."""
    x = c.reshape(
        (-1,) + tuple(f.shape[0] for f in factors) + tuple(f.shape[1] for f in factors)
    )
    for j, f in enumerate(factors):
        # (Z, m_j, .., m_k, p_j, .., p_k, d_1, .., d_{j-1}) -> (m_j, p_j)
        # contracted, d_j appended
        x = torch.tensordot(x, f, dims=([1, 1 + len(factors) - j], [0, 1]))
    return x.reshape(x.shape[0], -1)


def kron_probs(povm1, n_qubits: int, bloch):
    """Outcome probabilities 2^n (kron povm1) bloch, clipped to [0, 1].

    povm1 (m1, p1, 4); bloch (..., 4^n). Returns (..., m1^n, p1^n), the
    numbers of `state_core.experiment_probabilities` on the materialized
    POVM."""
    bloch = as_real(bloch)
    povm1 = as_real(povm1, like=bloch)
    out = _forward(povm1, n_qubits, bloch) * (2**n_qubits)
    return out.reshape(tuple(bloch.shape[:-1]) + tuple(out.shape[1:])).clamp(0.0, 1.0)


def kron_apply_adjoint(povm1, n_qubits: int, c):
    """(kron povm1)^T c for c (..., m1^n, p1^n); returns (..., 4^n)."""
    c = as_real(c)
    povm1 = as_real(povm1, like=c)
    out = _adjoint(povm1, n_qubits, c)
    return out.reshape(tuple(c.shape[:-2]) + (4**n_qubits,))


def kron_forward_flat(povm1, n_qubits: int, bloch):
    """The plain linear operator (kron povm1) bloch with the rows flattened,
    (..., (m1 p1)^n): no 2^n scaling and no clipping (dense twin:
    povm_matrix.reshape(-1, 4^n) @ bloch)."""
    bloch = as_real(bloch)
    povm1 = as_real(povm1, like=bloch)
    out = _forward(povm1, n_qubits, bloch)
    return out.reshape(tuple(bloch.shape[:-1]) + (-1,))


def kron_adjoint_flat(povm1, n_qubits: int, c):
    """(kron povm1)^T c for flat c (..., (m1 p1)^n); returns (..., 4^n)."""
    c = as_real(c)
    m1, p1 = povm1.shape[0], povm1.shape[1]
    return kron_apply_adjoint(
        povm1, n_qubits, c.reshape(tuple(c.shape[:-1]) + (m1**n_qubits, p1**n_qubits))
    )


def kron_row_component(povm1, n_qubits: int, component: int = 0) -> np.ndarray:
    """One bloch component of every flattened design row, ((m1 p1)^n,).

    A row is the kron of per-qubit rows, so its component 0 (the trace
    column) is the product of the per-qubit ones (dense twin:
    povm_flat[:, 0]). Only component 0 factorizes this way."""
    if component != 0:
        raise ValueError("only component 0 factorizes over the qubits")
    t = np.asarray(povm1, dtype=np.float64)[:, :, 0]
    out = t
    for _ in range(n_qubits - 1):
        out = np.einsum("mp,nq->mnpq", out, t).reshape(
            out.shape[0] * t.shape[0], out.shape[1] * t.shape[1]
        )
    return out.reshape(-1)


def kron_simulate(generator, povm1, bloch, n_shots):
    """Multinomial counts (..., m1^n, p1^n) on the factored design for
    bloch (..., 4^n), with `n_shots` shots per POVM; `generator` lives on
    the device of `bloch`. The one-block case of
    :func:`kron_simulate_chunked`."""
    return kron_simulate_chunked(generator, povm1, bloch, n_shots, n_calls=1)


def kron_simulate_chunked(generator, povm1, bloch, n_shots, n_calls: int | None = None):
    """Multinomial counts as :func:`kron_simulate` returns them, drawn in
    `n_calls` blocks over the first measurement group's m-axis.

    Each POVM row is an independent multinomial, so drawing the rows in
    blocks samples exactly the same design; the blocks are drawn from
    `generator` in block order, and the probabilities and draw
    intermediates of one block are alive at a time (the counts are
    assembled on the device). `n_calls=None` draws one block per
    first-group m row (27 blocks at 9-12 qubits of proj-set); with
    `n_calls=1` this is :func:`kron_simulate`, bit for bit.

    The JAX package picks between its fused and chunked draws by a cap on
    the TPU's single-execution time (`quantpy_tpu/tomography/state.py`);
    a CUDA launch has no such cap, so `StateTomograph` keeps the fused draw
    and this function is for draws whose intermediates must stay small.
    """
    bloch = as_real(bloch)
    with profiling.span("qt.kron.sample", bloch.device):
        povm1 = as_real(povm1, like=bloch)
        n_qubits = int(round(math.log(bloch.shape[-1], 4)))
        groups, factors = _grouped_factors(povm1, n_qubits)
        f0 = factors[0]
        m0 = f0.shape[0]
        n_calls = m0 if n_calls is None else max(1, min(int(n_calls), m0))
        block = -(-m0 // n_calls)
        x = bloch.reshape((-1,) + tuple(4**g for g in groups))

        def draw(f0_rows):
            probs = (_forward_chain([f0_rows] + factors[1:], x) * (2**n_qubits)).clamp(0.0, 1.0)
            n_arr = torch.full(probs.shape[:-1], float(n_shots), dtype=probs.dtype,
                               device=probs.device)
            return sample_multinomial(generator, n_arr, probs)

        if block >= m0:
            counts = draw(f0)
        else:
            rows = math.prod(f.shape[0] for f in factors[1:])
            counts = None
            for lo in range(0, m0, block):
                part = draw(f0[lo : lo + block])
                if counts is None:
                    counts = part.new_empty((x.shape[0], m0 * rows, part.shape[-1]))
                counts[:, lo * rows : lo * rows + part.shape[1]] = part
        return counts.reshape(tuple(bloch.shape[:-1]) + tuple(counts.shape[1:]))


def kron_nll_tril(tril_vec, povm1, n_qubits: int, freq_flat, m_total: int):
    """NLL of Cholesky parameter vectors on the factored design.

    The numbers of `state_core.nll_tril` on the materialized POVM with
    uniform row weights 1/m (the only weights the kron path supports);
    the probabilities run through the forward chain. Differentiable by
    autograd."""
    tril_vec = as_real(tril_vec)
    bloch = _unit_trace_bloch(real_tril_vec_to_matrix(tril_vec, 2**n_qubits))
    probs = kron_forward_flat(povm1, n_qubits, bloch) * (2**n_qubits / m_total)
    freq_flat = as_real(freq_flat, like=tril_vec)
    return -(freq_flat * torch.log(probs + _NLL_EPS)).sum(-1)


def _grouped_gram_inv(povm1, groups):
    """Per-group inverse Gram factors kron(G1^-1, ...) = (kron G1)^-1, with
    G1 = A1^T A1 the single-qubit Gram matrix of the flattened rows."""
    a1 = povm1.reshape(-1, povm1.shape[-1])
    g1 = torch.linalg.inv(a1.T @ a1)
    if g1.is_cuda:  # the error check reads the card's info back
        profiling.count("host_sync")
    out = []
    for g in groups:
        f = g1
        for _ in range(g - 1):
            f = torch.kron(f, g1)
        out.append(f)
    return out


def _frequencies(counts):
    return counts / counts.sum(dim=(-2, -1), keepdim=True)


def kron_estimate_lin(counts, povm1, n_qubits: int, physical: bool = True):
    """Linear inversion on the factored design (uniform weights).

    Solves the weighted least-squares problem of `state_core.estimate_lin`
    (the weights 1/M cancel between the Gram matrix and the right-hand
    side) with one inverse Gram factor per group; nothing larger than the
    counts is formed. counts (..., m1^n, p1^n); returns (..., 4^n)."""
    counts = as_real(counts)
    povm1 = as_real(povm1, like=counts)
    rhs = _adjoint(povm1, n_qubits, _frequencies(counts))
    return _lin_from_rhs(rhs, povm1, n_qubits, counts.shape[-2], physical).reshape(
        tuple(counts.shape[:-2]) + (4**n_qubits,)
    )


def _lin_from_rhs(rhs, povm1, n_qubits: int, m_total: int, physical: bool):
    """Linear inversion from the adjoint of the frequencies, rhs (Z, 4^n):
    the inverse Gram factors per group, then the feasibility projection if
    `physical`."""
    with profiling.span("qt.kron.lin.solve", rhs.device):
        groups = group_sizes(n_qubits)
        x = rhs.reshape((-1,) + tuple(4**g for g in groups))
        for g_inv in _grouped_gram_inv(povm1, groups):
            x = torch.tensordot(x, g_inv, dims=([1], [0]))
        # undo the uniform weighting: A_w = A / M in the Gram (1/M^2) and rhs (1/M)
        bloch = x.reshape(rhs.shape) * m_total / (2**n_qubits)
    if physical:
        with profiling.span("qt.kron.lin.clip", bloch.device):
            profiling.count("eigh", bloch.shape[0])
            profiling.count("clip_kernel", 0)  # the key, whichever route the clip takes
            bloch = make_feasible_bloch(bloch, n_qubits)
    return bloch


def kron_estimate_mle_rhor(
    counts,
    povm1,
    n_qubits: int,
    init_bloch=None,
    max_iter: int = 100,
    tol: float = 1e-6,
):
    """RrhoR fixed-point MLE with the factored chains (uniform weights).

    The fixed point of `state_core.estimate_mle_rhor` on the materialized
    POVM: the start is mixed 5% toward I/d, and the loop stops once max
    |bloch change| over the batch is not above `tol`, or after `max_iter`
    iterations."""
    counts = as_real(counts)
    povm1 = as_real(povm1, like=counts)
    dim = 2**n_qubits
    m_total = counts.shape[-2]
    scale = dim / m_total  # weighted effects (w_m = 1/M) times 2^n
    freq = _frequencies(counts)
    if init_bloch is None:
        init_bloch = kron_estimate_lin(counts, povm1, n_qubits, physical=True)
    bloch0 = _mixed_start(as_real(init_bloch, like=counts), dim, 0.05)

    def r_of(bloch):
        profiling.count("iters")
        probs = kron_probs(povm1, n_qubits, bloch) / m_total
        return kron_apply_adjoint(povm1, n_qubits, freq / probs.clamp(min=_NLL_EPS)) * scale

    with profiling.span("qt.kron.rhor", counts.device):
        profiling.count("resamples", math.prod(bloch0.shape[:-1]))
        return _rhor_iterate(r_of, bloch0, n_qubits, max_iter, tol)


def _kron_bootstrap_chunk(
    generator, bloch_est, povm1, n_qubits, n_shots, n_points, method, dst, max_iter,
    physical, init,
):
    """Simulate, estimate and measure `n_points` resamples in one go."""
    blochs = bloch_est.expand((n_points,) + tuple(bloch_est.shape))
    counts = kron_simulate(generator, povm1, blochs, n_shots)
    if method == "lin":
        est = kron_estimate_lin(counts, povm1, n_qubits, physical=physical)
    elif method in ("mle", "mle-rhor"):
        if init == "mixed":
            init_bloch = bloch_est.new_zeros((n_points, 4**n_qubits))
            init_bloch[:, 0] = 1.0 / 2**n_qubits
        elif init == "lin":
            init_bloch = None
        else:
            raise ValueError("Invalid value for argument `init`")
        est = kron_estimate_mle_rhor(
            counts, povm1, n_qubits, init_bloch=init_bloch, max_iter=max_iter
        )
    else:
        raise ValueError(f"method {method!r} unsupported on the kron path")
    return _distance_batch(dst, est, bloch_est, n_qubits)


def kron_bootstrap_distances(
    generator,
    bloch_est,
    povm1,
    n_qubits: int,
    n_shots,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
    physical: bool = True,
    init: str = "lin",
    chunk: int | None = None,
):
    """Parametric bootstrap on the factored design: simulate, estimate and
    measure `n_points` resamples from `bloch_est` (4^n,); returns their
    UNSORTED distances (n_points,).

    `physical` applies to the 'lin' re-estimates; `init` ('lin' | 'mixed')
    selects the MLE start; 'mle' and 'mle-rhor' both run RrhoR. The
    resamples run in chunks of `chunk` (None: as many as keep a chunk's
    counts within CHUNK_COUNT_ENTRIES, at least one), drawing from
    `generator` in turn."""
    bloch_est = as_real(bloch_est)
    povm1 = as_real(povm1, like=bloch_est)
    m1, p1 = povm1.shape[0], povm1.shape[1]
    if chunk is None:
        chunk = max(1, min(n_points, CHUNK_COUNT_ENTRIES // (m1 * p1) ** n_qubits))
    with profiling.span("qt.kron.bootstrap", bloch_est.device):
        profiling.count("resamples", n_points)
        profiling.count("chunks", -(-n_points // chunk))
        parts = [
            _kron_bootstrap_chunk(
                generator, bloch_est, povm1, n_qubits, n_shots, min(chunk, n_points - start),
                method, dst, max_iter, physical, init,
            )
            for start in range(0, n_points, chunk)
        ]
        return torch.cat(parts)
