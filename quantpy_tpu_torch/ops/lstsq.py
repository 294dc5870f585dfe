"""Least-squares primitives (port of quantpy_tpu/ops/lstsq.py).

Both go through a solve of the normal equations; the explicit left inverse
is kept for the callers that inspect its entries.
"""

from __future__ import annotations

import torch

__all__ = ["left_inverse", "lstsq_solve"]


def left_inverse(a: torch.Tensor) -> torch.Tensor:
    """The explicit left inverse (A^T A)^{-1} A^T, batched. A^T is the plain
    transpose, also for a complex A; for a real A of full column rank this
    is the Moore-Penrose inverse."""
    a = torch.as_tensor(a)
    at = a.transpose(-1, -2)
    return torch.linalg.solve(at @ a, at)


def lstsq_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve min ||A x - b||_2 through the normal equations, batched.
    A: (..., m, n); b: (..., m) or (..., m, k)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    at = a.transpose(-1, -2)
    vec_input = b.ndim == a.ndim - 1
    if vec_input:
        b = b[..., None]
    x = torch.linalg.solve(at @ a, at @ b)
    return x[..., 0] if vec_input else x
