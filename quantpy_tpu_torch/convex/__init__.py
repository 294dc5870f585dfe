"""Convex optimization for the confidence intervals: the closed-form
sliced-ball bounds and the batched PDHG linear programs."""

from .ball import linear_bounds_on_ball_slice
from .lp import solve_lp_batch, solve_lp_batch_factors, solve_lp_batch_kron

__all__ = [
    "linear_bounds_on_ball_slice",
    "solve_lp_batch",
    "solve_lp_batch_factors",
    "solve_lp_batch_kron",
]
