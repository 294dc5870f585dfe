"""Double-float (two-float compensated) elementwise arithmetic on float32
tensors (port of quantpy_tpu/ops/df32.py).

A value is a pair (hi, lo) of float32 tensors whose sum carries about 48
bits of mantissa. The primitives are the classical error-free
transformations (Knuth TwoSum; Dekker split and TwoProduct, with no FMA
assumed, so products split into 12-bit halves that multiply exactly in
float32) composed into renormalized pairs. log1p uses 2^K-th-root argument
reduction (K double-float square roots, each one Newton step over the
hardware sqrt) followed by the odd atanh series at |u| <= ~0.22.

The JAX package needs these because the TPU's float32 divide and log1p
are a few ulp off; it guards each rounding-error recovery with an
optimization barrier, since XLA's simplifier rewrites (a + b) - a to b.
Torch's eager mode runs every operation as written and never reassociates,
so plain tensor operations suffice here. This module is therefore not for
`torch.compile`, whose code generation may simplify the same expressions.

Everything is branch-free and differentiable: autograd flows through the
float32 data path (the compensation terms carry tiny gradients). Nothing
on the port's main path uses it; the port's anchored NLL reduces in
float64 instead (`tomography/process_core.py`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "two_sum",
    "two_prod",
    "df_add",
    "df_add_f",
    "df_mul",
    "df_mul_f",
    "df_div_ff",
    "df_sqrt",
    "df_log1p_f",
    "sum2f",
]

_SPLIT = 4097.0  # 2**12 + 1: splits a 24-bit float32 mantissa into 12+12


def two_sum(a, b):
    """Knuth's error-free sum: a + b = s + err exactly (6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Renormalize assuming |a| >= |b| (3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    """Dekker split: a = hi + lo with 12-bit halves (exact float32
    products)."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's error-free product: a * b = p + err exactly (FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(x, y):
    """(hi, lo) + (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    return _quick_two_sum(s, e + (x[1] + y[1]))


def df_add_f(x, f):
    """(hi, lo) + plain float."""
    s, e = two_sum(x[0], f)
    return _quick_two_sum(s, e + x[1])


def df_mul(x, y):
    """(hi, lo) * (hi, lo)."""
    p, e = two_prod(x[0], y[0])
    return _quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def df_mul_f(x, f):
    """(hi, lo) * plain float."""
    p, e = two_prod(x[0], f)
    return _quick_two_sum(p, e + x[1] * f)


def df_div_ff(a, b):
    """plain / plain -> (hi, lo): one exact-residual correction of the
    hardware quotient (accurate to ~2^-48 relative)."""
    q0 = a / b
    p, e = two_prod(q0, b)
    r = (a - p) - e  # a - q0*b, exact (p within one ulp of a)
    return _quick_two_sum(q0, r / b)


def df_sqrt(x):
    """sqrt of (hi, lo): one double-float Newton step over the hardware
    sqrt."""
    y0 = torch.sqrt(x[0])
    p, e = two_prod(y0, y0)
    d = ((x[0] - p) - e) + x[1]
    return _quick_two_sum(y0, d / (2.0 * y0))


_LOG1P_HALVINGS = 6  # (1+r) -> (1+r)^(1/64): |u| <= ~0.22 for r in [1e-12-1, 1e12]
_ATANH_TERMS = 8  # odd series through u^15: truncation < 4e-12 at |u| = 0.25


def df_log1p_f(r):
    """log1p of a float32 tensor, returned as (hi, lo) with ~2^-48
    relative accuracy (plus a 2^(K+1) * 2^-48 absolute floor from the
    argument reduction). Valid for r in (~1e-12 - 1, ~1e12)."""
    w = two_sum(1.0, r)  # exact: 1 + r as a double-float
    for _ in range(_LOG1P_HALVINGS):
        w = df_sqrt(w)
    v = df_add_f(w, -1.0)  # w - 1: Sterbenz-exact near 1
    u = _df_div(v, df_add_f(v, 2.0))
    u2 = df_mul(u, u)
    s = _atanh_coef(_ATANH_TERMS - 1, r.device)
    for k in range(_ATANH_TERMS - 2, -1, -1):
        s = df_add(_atanh_coef(k, r.device), df_mul(u2, s))
    s = df_mul(u, s)
    scale = float(2 ** (_LOG1P_HALVINGS + 1))
    return s[0] * scale, s[1] * scale


def _df_div(x, y):
    """(hi, lo) / (hi, lo)."""
    q0 = x[0] / y[0]
    p, e = two_prod(q0, y[0])
    r = ((x[0] - p) - e) + (x[1] - q0 * y[1])
    return _quick_two_sum(q0, r / y[0])


def _atanh_coef(k: int, device):
    """1/(2k+1) as an (hi, lo) pair of float32 scalar tensors (exact to
    ~2^-48): tensors, so that Dekker's split of a coefficient runs in
    float32."""
    c = 1.0 / np.float64(2 * k + 1)
    hi = np.float32(c)
    lo = np.float32(c - np.float64(hi))
    return (torch.tensor(hi, dtype=torch.float32, device=device),
            torch.tensor(lo, dtype=torch.float32, device=device))


def sum2f(x, lo=None):
    """Two-float pairwise-tree sum over the last axis: each level combines
    pairs with TwoSum and accumulates the exact per-pair errors into a
    running low part (~2x the float32 mantissa at log2(N) levels)."""
    if lo is None:
        lo = torch.zeros_like(x)
    n = x.shape[-1]
    m = 1 << (n - 1).bit_length()
    if m != n:
        x = torch.nn.functional.pad(x, (0, m - n))
        lo = torch.nn.functional.pad(lo, (0, m - n))
    while x.shape[-1] > 1:
        s, e = two_sum(x[..., 0::2], x[..., 1::2])
        lo = lo[..., 0::2] + lo[..., 1::2] + e
        x = s
    return x[..., 0] + lo[..., 0]
