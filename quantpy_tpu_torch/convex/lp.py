"""Batched linear programs by PDHG (Chambolle-Pock), port of
quantpy_tpu/convex/lp.py.

    min <c, x>  s.t.  A x <= b

for a batch of right-hand sides b (one per polytope margin delta, for +c
and -c), all iterated at once on the device of b:

    y_{k+1} = max(0, y_k + sigma (A xbar_k - b))
    x_{k+1} = x_k - tau (c + A^T y_{k+1})
    xbar_{k+1} = 2 x_{k+1} - x_k

with tau * sigma * ||A||^2 < 1, or Pock-Chambolle diagonal steps.

The schedule is the JAX package's: chunks of `_CHUNK` iterations, and after
each chunk the batch-maximum residuals (primal feasibility
||(Ax - b)_+||_inf, dual feasibility ||c + A^T y||_inf, and the gap
|c^T x + b^T y|) against tol * (1 + problem scale). Reading those three
numbers once per chunk is the only host synchronization of the loop.

Three solvers share the loop: a dense A, the kron-factored state design
(never materialized) and a two-factor A = left (x) right (the process
design). They follow the dtype and device of `b_batch` (a numpy `b_batch`
takes the port's defaults); the O(D) step sizes and operator norms are
host numpy in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import as_real

__all__ = ["solve_lp_batch", "solve_lp_batch_kron", "solve_lp_batch_factors"]

#: iterations per convergence check
_CHUNK = 500


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, dtype=np.float64)


def _step(base, update, step):
    """base + step * update, for a Python-float or a tensor step."""
    if isinstance(step, torch.Tensor):
        return torch.addcmul(base, step, update)
    return torch.add(base, update, alpha=step)


def _default_tol(dtype) -> float:
    """The stopping tolerance when the caller gives none."""
    return 1e-9 if dtype == torch.float64 else 3e-5


def _pdhg(fwd, adj, c, b, tau, sigma, n_iter: int, tol):
    """The chunked PDHG loop with residual-based early stopping.

    c (P, D) or (D,), b (P, K); fwd maps (P, D) -> (P, K), adj the
    reverse. tau and sigma are Python floats or per-variable /
    per-constraint tensors. Returns (x, obj, viol, iters)."""
    if tol is None:
        tol = _default_tol(b.dtype)
    neg_tau = -tau
    b_scale, c_scale = (1.0 + torch.stack([b.abs().amax(), c.abs().amax()])).tolist()
    x = torch.zeros(b.shape[:-1] + c.shape[-1:], dtype=b.dtype, device=b.device)
    xbar = x
    y = torch.zeros_like(b)
    iters = 0
    obj = viol = None
    while iters < n_iter:
        for _ in range(_CHUNK):
            y = _step(y, fwd(xbar).sub_(b), sigma).clamp_(min=0.0)
            x_new = _step(x, adj(y).add_(c), neg_tau)
            xbar = torch.lerp(x, x_new, 2.0)  # 2 x_new - x
            x = x_new
        iters += _CHUNK
        obj, viol, stats = _residuals(fwd, adj, c, b, x, y)
        res_p, res_d, gap, scale = stats.tolist()
        if res_p <= tol * b_scale and res_d <= tol * c_scale and gap <= tol * scale:
            break
    if obj is None:
        obj, viol, _ = _residuals(fwd, adj, c, b, x, y)
    return x, obj, viol, iters


def _residuals(fwd, adj, c, b, x, y):
    """(obj, viol, [res_p, res_d, gap, scale]) of the iterate (x, y)."""
    viol = (fwd(x) - b).clamp_(min=0.0).amax(-1)
    obj = (c * x).sum(-1)
    d_obj = -(b * y).sum(-1)
    stats = torch.stack([
        viol.amax(),
        (c + adj(y)).abs().amax(),
        (obj - d_obj).abs().amax(),
        1.0 + obj.abs().amax() + d_obj.abs().amax(),
    ])
    return obj, viol, stats


def _batch(c, b, d_shape: int):
    """Flatten b (..., K) to (P, K) and c (D,) or (..., D) alike."""
    lead = b.shape[:-1]
    b2 = b.reshape(-1, b.shape[-1])
    c2 = c if c.ndim == 1 else c.expand(lead + (d_shape,)).reshape(-1, d_shape)
    return c2, b2, lead


def _unbatch(lead, x, obj, viol, iters):
    return x.reshape(lead + x.shape[-1:]), obj.reshape(lead), viol.reshape(lead), iters


def solve_lp_batch(c, a_matrix, b_batch, n_iter: int = 20000, tol: float | None = None):
    """Solve min <c, x> s.t. A x <= b for a batch of right-hand sides.

    Parameters
    ----------
    c : (D,) or (..., D) objective(s)
    a_matrix : (K, D) constraint matrix (shared)
    b_batch : (..., K) right-hand sides; their dtype and device are used
    n_iter : iteration cap (checked every 500 iterations)
    tol : residual/duality-gap tolerance for early stopping; default
        1e-9 in float64, 3e-5 in float32

    Returns
    -------
    x : (..., D) solutions
    obj : (...,) objective values
    viol : (...,) max residual constraint violation (diagnostic)
    iters : number of iterations run
    """
    b = as_real(b_batch)
    a = as_real(a_matrix, like=b)
    c2, b2, lead = _batch(as_real(c, like=b), b, a.shape[1])
    norm = float(np.linalg.norm(_host64(a), ord=2))
    a_t = a.T.contiguous()
    step = 0.9 / norm
    return _unbatch(
        lead, *_pdhg(lambda v: v @ a_t, lambda w: w @ a, c2, b2, step, step, n_iter, tol)
    )


def solve_lp_batch_kron(
    c, povm1, n_qubits: int, b_batch, n_iter: int = 20000, tol: float | None = None
):
    """Factored twin of :func:`solve_lp_batch` for kron-mode tomographs.

    Solves min <c, x> s.t. 2^n (kron povm1 rows)[:, 1:] x <= b for a batch
    of right-hand sides without materializing the constraint matrix: the
    variables are the traceless bloch components, and A and A^T are the
    factored chains of `kron_core`. Same return signature as
    solve_lp_batch.
    """
    # imported here: the tomography package imports this module
    from ..tomography.kron_core import kron_adjoint_flat, kron_forward_flat

    b = as_real(b_batch)
    # 2^n kron(povm1) = kron(2 povm1): the power-of-two scale is exact
    povm2 = 2.0 * as_real(povm1, like=b)
    c2, b2, lead = _batch(as_real(c, like=b), b, 4**n_qubits - 1)
    # ||A||_2 <= 2^n sigma_max(A1)^n; dropping the trace column only
    # shrinks the norm, so this keeps tau * sigma * ||A||^2 < 1
    a1 = _host64(povm1).reshape(-1, 4)
    norm = 2.0**n_qubits * float(np.linalg.svd(a1, compute_uv=False)[0]) ** n_qubits
    zero = torch.zeros(b2.shape[:-1] + (1,), dtype=b.dtype, device=b.device)

    def fwd(v):
        return kron_forward_flat(povm2, n_qubits, torch.cat([zero, v], dim=-1))

    def adj(w):
        return kron_adjoint_flat(povm2, n_qubits, w)[..., 1:]

    step = 0.9 / norm
    return _unbatch(lead, *_pdhg(fwd, adj, c2, b2, step, step, n_iter, tol))


def solve_lp_batch_factors(
    c, left, right, b_batch, n_iter: int = 20000, tol: float | None = None
):
    """Two-Kronecker-factor twin of :func:`solve_lp_batch`.

    Solves min <c, x> s.t. (left (x) right) x <= b for a batch of
    right-hand sides without materializing the constraint matrix. `c` is
    (A, B) or (..., A, B); `left` (S, A); `right` (K, B); `b_batch`
    (..., S, K). Returns (x, obj, viol, iters) with x of shape
    (..., A, B) and flattened-column order matching
    kron(left, right) = einsum('sa,kb->skab').reshape(S K, A B).
    """
    b = as_real(b_batch)
    left_t = as_real(left, like=b)
    right_t = as_real(right, like=b)
    c = as_real(c, like=b)
    n_s, a_dim = left_t.shape
    n_k, b_dim = right_t.shape
    c2, b2, lead = _batch(
        c.reshape(c.shape[:-2] + (a_dim * b_dim,)), b.reshape(b.shape[:-2] + (n_s * n_k,)),
        a_dim * b_dim,
    )
    # Pock-Chambolle diagonal steps (alpha = 1): per-variable
    # tau_j = 1/sum_i |A_ij| and per-constraint sigma_i = 1/sum_j |A_ij|,
    # for A = kron(L, R) outer products of the factors' abs-sums. The
    # scalar 0.9/||A|| steps stall on this badly row-scaled LP (the
    # 4-qubit process polytope ran its full 20k-iteration budget without
    # reaching feasibility in the JAX package).
    l_abs = np.abs(_host64(left_t))
    r_abs = np.abs(_host64(right_t))
    eps = 1e-30
    tau = 1.0 / np.maximum(np.outer(l_abs.sum(axis=0), r_abs.sum(axis=0)).reshape(-1), eps)
    sigma = 1.0 / np.maximum(np.outer(l_abs.sum(axis=1), r_abs.sum(axis=1)).reshape(-1), eps)
    rows = left_t.T.contiguous()
    cols = right_t.T.contiguous()

    # left first in the forward map and right first in the adjoint: both
    # pass through (P, S, B), the cheaper order at every process size
    def fwd(v):
        return torch.matmul(torch.matmul(left_t, v.view(-1, a_dim, b_dim)), cols).view(
            -1, n_s * n_k)

    def adj(w):
        return torch.matmul(rows, torch.matmul(w.view(-1, n_s, n_k), right_t)).view(
            -1, a_dim * b_dim)

    x, obj, viol, iters = _unbatch(
        lead, *_pdhg(fwd, adj, c2, b2, as_real(tau, like=b), as_real(sigma, like=b),
                     n_iter, tol)
    )
    return x.reshape(lead + (a_dim, b_dim)), obj, viol, iters
