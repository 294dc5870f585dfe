"""Closed-form linear optimization over a ball intersected with an affine
coordinate slice (port of quantpy_tpu/convex/ball.py).

The MomentFidelity intervals bound, per confidence level,

    min / max  <c, x>
    s.t.       x[fixed_idx] = fixed_vals          (unit trace / TP coords)
               ||x - center||_2 <= r

Within the slice the feasible set is a ball of radius
r_t = sqrt(r^2 - ||center[fixed] - fixed_vals||^2) centered at center with
the fixed coordinates replaced, so a linear functional attains
center-value -/+ r_t * ||c_free||: one vectorized expression for every
level. Host numpy: the work is O(D) per level.
"""

from __future__ import annotations

import numpy as np

__all__ = ["linear_bounds_on_ball_slice"]


def linear_bounds_on_ball_slice(c, center, radii, fixed_idx, fixed_vals):
    """Batched min/max of <c, x> over the sliced ball.

    Parameters
    ----------
    c : (D,) objective vector
    center : (D,) ball center
    radii : (...,) ball radii (batched)
    fixed_idx : (F,) int indices of coordinates fixed by the affine slice
    fixed_vals : (F,) their values

    Returns
    -------
    (mins, maxs) with shape radii.shape; NaN where the slice is infeasible
    (r^2 < ||center_fixed - vals||^2).
    """
    c = np.asarray(c, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    radii = np.asarray(radii, dtype=np.float64)
    fixed_idx = np.asarray(fixed_idx, dtype=np.intp)
    fixed_vals = np.asarray(fixed_vals, dtype=np.float64)

    free_mask = np.ones(c.shape[0], dtype=bool)
    free_mask[fixed_idx] = False

    h2 = np.sum((center[fixed_idx] - fixed_vals) ** 2)
    rt2 = radii**2 - h2
    feasible = rt2 >= 0
    rt = np.sqrt(np.where(feasible, rt2, np.nan))

    base = float(c[fixed_idx] @ fixed_vals + c[free_mask] @ center[free_mask])
    c_norm = float(np.linalg.norm(c[free_mask]))
    return base - rt * c_norm, base + rt * c_norm
