"""Batched L-BFGS with a strong-Wolfe zoom line search, in plain PyTorch.

Minimizes B independent smooth functions at once: `fun` maps parameters
(B, P) to values (B,), row b depending only on row b of its argument.
Every resample keeps its own history, line search and stop, and each step
is one set of batched tensor operations; there is no loop over the rows.

The method follows the defaults of optax 0.2.6's `optax.lbfgs()`, which the
JAX package runs under `vmap`:

- a history of `memory` pairs (s, y) per row and the two-loop recursion,
  with the identity scaled by s^T y / y^T y of the newest pair (by
  min(1, 1 / ||g||) on the first step);
- a pair with s^T y <= 0 gets weight 0, so the recursion skips it;
- the zoom line search of Nocedal and Wright (Algorithms 3.5 and 3.6) with
  optax's rules: first trial step 1, doubling while no interval is found,
  cubic then quadratic interpolation then bisection, the strong Wolfe
  conditions (slope 1e-4, curvature 0.9) with Hager and Zhang's
  approximate-decrease alternative (1e-6), a fallback to the best step of
  sufficient decrease, at most 20 trials;
- a row runs while its iteration count is below `max_iter` and the norm
  of the gradient at the start of its previous step is above `tol`, as the
  JAX package's `lax.while_loop` checks it; a row that has stopped keeps
  its parameters (masked), as `vmap` of that loop keeps them.

Gradients come from autograd on the summed values: the rows are
independent, so the gradient of the sum holds each row's own gradient.
"""

from __future__ import annotations

import torch

__all__ = ["lbfgs_minimize"]

SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0
MAX_LINESEARCH_STEPS = 20


def _value_and_grad(fun, x):
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        value = fun(x)
        (grad,) = torch.autograd.grad(value.sum(), x)
    return value.detach(), grad


def _dot(a, b):
    return (a * b).sum(-1)


def _where(mask, new, old):
    """Row-wise select; `mask` (B,) broadcasts over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none (then unused)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    u, v = fb - fa - fpa * db, fc - fa - fpa * dc
    big_a = (dc**2 * u - db**2 * v) / denom
    big_b = (-(dc**3) * u + db**3 * v) / denom
    radical = big_b * big_b - 3.0 * big_a * fpa
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    big_b = (fb - fa - fpa * db) / db**2
    return a - fpa / (2.0 * big_b)


def _errors(step, value, slope, value_init, slope_init):
    """(decrease error, curvature error), each >= 0 and 0 where the
    condition holds; NaN counts as infinitely violated."""
    armijo = value - value_init - SLOPE_RTOL * step * slope_init
    approx = torch.maximum(
        slope - (2 * SLOPE_RTOL - 1.0) * slope_init,
        value - value_init - APPROX_DEC_RTOL * value_init.abs(),
    )
    decrease = torch.minimum(approx, armijo).clamp(min=0.0)
    curvature = (slope.abs() - CURV_RTOL * slope_init.abs()).clamp(min=0.0)
    inf = torch.full_like(decrease, float("inf"))
    return (torch.where(decrease.isnan(), inf, decrease),
            torch.where(curvature.isnan(), inf, curvature))


def _line_search(fun, x, direction, value, grad, rows):
    """Zoom line search along `direction` for the rows in the mask `rows`.

    Returns (step, value, grad) at the accepted step of each row; rows
    outside the mask get step 0 and keep `value` and `grad`."""
    zero = torch.zeros_like(value)
    slope0 = _dot(direction, grad)
    st = {
        "step": zero, "value": value, "grad": grad, "slope": slope0,
        "dec": torch.full_like(value, float("inf")),
        "low": zero, "v_low": value, "s_low": slope0,
        "high": zero, "v_high": value, "s_high": slope0,
        "ref": zero, "v_ref": value,
        "safe": zero, "v_safe": value, "g_safe": grad,
    }
    found = torch.zeros_like(rows)
    finished = ~rows
    for count in range(MAX_LINESEARCH_STEPS):
        searching = ~finished
        if not bool(searching.any()):
            break
        low, high = st["low"], st["high"]
        # the next trial: grow the step while no interval is found, else
        # interpolate inside it
        grow = torch.full_like(value, 1.0) if count == 0 else INCREASE_FACTOR * st["step"]
        delta = (high - low).abs()
        left, right = torch.minimum(low, high), torch.maximum(low, high)
        cubic = _cubicmin(low, st["v_low"], st["s_low"], high, st["v_high"], st["ref"],
                          st["v_ref"])
        use_cubic = (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)
        quad = _quadmin(low, st["v_low"], st["s_low"], high, st["v_high"])
        use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, cubic, torch.where(use_quad, quad, (low + high) / 2))
        trial = torch.where(found, middle, grow)
        trial = torch.where(searching, trial, zero)

        v, g = _value_and_grad(fun, x + trial[:, None] * direction)
        s = _dot(g, direction)
        dec, curv = _errors(trial, v, s, value, slope0)
        ok = (dec <= 0) & (curv <= 0)

        # the best step of sufficient decrease so far, kept as a fallback
        keep_safe = (dec <= 0) & (~found | (v < st["v_safe"]))
        new = dict(st)
        new["safe"] = torch.where(keep_safe, trial, st["safe"])
        new["v_safe"] = torch.where(keep_safe, v, st["v_safe"])
        new["g_safe"] = _where(keep_safe, g, st["g_safe"])

        # bracketing phase (Nocedal and Wright, Algorithm 3.5)
        high_new = (dec > 0) | ((v >= st["value"]) & (count > 0))
        low_new = (s >= 0) & ~high_new
        b_low = torch.where(low_new, trial, st["step"])
        b_v_low = torch.where(low_new, v, st["value"])
        b_s_low = torch.where(low_new, s, st["slope"])
        b_high = torch.where(low_new, st["step"], trial)
        b_v_high = torch.where(low_new, st["value"], v)
        b_s_high = torch.where(low_new, st["slope"], s)

        # zoom phase (Algorithm 3.6)
        z_high_mid = (dec > 0) | (v >= st["v_low"])
        z_high_low = (s * (high - low) >= 0) & ~z_high_mid
        z_high = torch.where(z_high_low, low, torch.where(z_high_mid, trial, high))
        z_v_high = torch.where(z_high_low, st["v_low"],
                               torch.where(z_high_mid, v, st["v_high"]))
        z_s_high = torch.where(z_high_low, st["s_low"],
                               torch.where(z_high_mid, s, st["s_high"]))
        z_low = torch.where(z_high_mid, low, trial)
        z_v_low = torch.where(z_high_mid, st["v_low"], v)
        z_s_low = torch.where(z_high_mid, st["s_low"], s)
        moved_high = z_high_mid | z_high_low
        z_ref = torch.where(moved_high, high, low)
        z_v_ref = torch.where(moved_high, st["v_high"], st["v_low"])

        for key, b_val, z_val in (
            ("low", b_low, z_low), ("v_low", b_v_low, z_v_low), ("s_low", b_s_low, z_s_low),
            ("high", b_high, z_high), ("v_high", b_v_high, z_v_high),
            ("s_high", b_s_high, z_s_high), ("ref", b_low, z_ref),
            ("v_ref", b_v_low, z_v_ref),
        ):
            new[key] = torch.where(found, z_val, b_val)
        new["step"], new["value"], new["grad"], new["slope"], new["dec"] = trial, v, g, s, dec

        last = count + 1 >= MAX_LINESEARCH_STEPS
        too_small = (delta <= INTERVAL_THRESHOLD) & (new["safe"] > 0)
        failed = ~ok & (last | (found & too_small))
        # a failed search returns its best step of sufficient decrease, or
        # no step where the trial left the function's domain
        fallback = failed & ((new["safe"] > 0) | dec.isinf())
        new["step"] = torch.where(fallback, new["safe"], new["step"])
        new["value"] = torch.where(fallback, new["v_safe"], new["value"])
        new["grad"] = _where(fallback, new["g_safe"], new["grad"])

        for key, val in new.items():
            st[key] = _where(searching, val, st[key])
        found = found | (searching & (high_new | low_new | ok))
        finished = finished | ok | failed
    step = torch.where(rows, st["step"], zero)
    return step, _where(rows, st["value"], value), _where(rows, st["grad"], grad)


def _two_loop(grad, s_mem, y_mem, weights, newest: int, gamma):
    """The L-BFGS direction H g by the two-loop recursion over a ring of
    pairs, newest at slot `newest`."""
    memory = weights.shape[0]
    order = [(newest - j) % memory for j in range(memory)]  # newest first
    q = grad
    alphas = {}
    for i in order:
        alphas[i] = weights[i] * _dot(s_mem[i], q)
        q = q - alphas[i][:, None] * y_mem[i]
    r = gamma[:, None] * q
    for i in reversed(order):
        beta = weights[i] * _dot(y_mem[i], r)
        r = r + (alphas[i] - beta)[:, None] * s_mem[i]
    return r


def lbfgs_minimize(fun, x0, max_iter: int = 100, tol: float = 1e-6, memory: int = 10):
    """Minimize each row of `fun` from `x0` (B, P); returns (B, P).

    `fun` maps (B, P) to (B,) and must be differentiable by autograd."""
    x = x0.detach()
    batch = x.shape[0]
    value, grad = _value_and_grad(fun, x)
    s_mem = x.new_zeros((memory,) + tuple(x.shape))
    y_mem = x.new_zeros((memory,) + tuple(x.shape))
    weights = x.new_zeros((memory, batch))
    prev_x, prev_g = x, grad
    gnorm_prev = torch.full_like(value, float("inf"))
    for it in range(int(max_iter)):
        active = gnorm_prev > tol
        if not bool(active.any()):
            break
        gnorm = grad.norm(dim=-1)
        if it == 0:
            gamma = torch.clamp(1.0 / gnorm, max=1.0)
        else:
            s, y = x - prev_x, grad - prev_g
            sy, yy = _dot(s, y), _dot(y, y)
            slot = (it - 1) % memory
            s_mem[slot], y_mem[slot] = s, y
            weights[slot] = torch.where(sy > 0, 1.0 / sy, torch.zeros_like(sy))
            gamma = torch.where((sy > 0) & (yy > 0), sy / yy, torch.ones_like(sy))
        direction = -_two_loop(grad, s_mem, y_mem, weights, (it - 1) % memory, gamma)
        prev_x, prev_g = x, grad
        step, new_value, new_grad = _line_search(fun, x, direction, value, grad, active)
        x = _where(active, x + step[:, None] * direction, x)
        value = torch.where(active, new_value, value)
        grad = _where(active, new_grad, grad)
        gnorm_prev = torch.where(active, gnorm, gnorm_prev)
    return x
