"""Confidence-polytope margin <-> confidence-level conversion
(arXiv:2109.04734), port of quantpy_tpu/tomography/polytopes/utils.py.

`frequencies` may be (m, p) for states or (S, m, p) for processes;
`n_measurements` is (m,) and broadcasts over the leading axes. Both
functions compute in the dtype and on the device of `frequencies` (a numpy
table takes the port's defaults) and are batched over `delta` and
`target_cl`; the coverage harness calls the same arithmetic batched over
trials as well (`_confidence`, `_bisect`).
"""

from __future__ import annotations

import torch

from ...config import as_real

__all__ = ["count_confidence", "count_delta"]

_EPS = 1e-15
#: fixed bisection depth on (1e-10, 1): the interval shrinks below 1e-10
_HALVINGS = 34


def _confidence(d, f, n, n_event: int):
    """The KL/Hoeffding confidence of margins `d` for frequency tables `f`
    whose last `n_event` axes are one experiment ([S,] m, p); `d` and `f`
    broadcast, and the result has the broadcast shape without the event
    axes. `n` holds the shots per POVM, (m,)."""
    fpd = torch.clamp(f + d, _EPS, 1 - _EPS)
    kl = f * torch.log(f / fpd) + (1 - f) * torch.log((1 - f) / (1 - fpd))
    kl = torch.where(f + d < 1 - _EPS, kl, torch.inf)
    eps = torch.exp(-n[:, None] * kl)
    eps = torch.where(torch.abs(f - 1) < 2 * _EPS, 0.0, eps)
    per_povm = torch.clamp(1 - eps.sum(-1), min=0.0)
    return per_povm.flatten(per_povm.ndim - (n_event - 1)).prod(-1)


def _bisect(confidence, target):
    """The smallest margin on (1e-10, 1) whose `confidence` reaches
    `target`, by `_HALVINGS` halvings; `confidence` maps margins of the
    shape of `target` to confidences of that shape."""
    lo = torch.full_like(target, 1e-10)
    hi = torch.ones_like(target)
    for _ in range(_HALVINGS):
        mid = (lo + hi) / 2
        go_right = confidence(mid) < target + 1e-10
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    return (lo + hi) / 2


def count_confidence(delta, frequencies, n_measurements):
    """Confidence that the true probabilities lie within +delta of the
    observed frequencies, via the KL/Hoeffding bound. `delta` may be
    batched (...,); the result has its shape."""
    f = as_real(frequencies)
    n = as_real(n_measurements, like=f)
    delta = as_real(delta, like=f)
    d = delta.reshape(delta.shape + (1,) * f.ndim)
    return _confidence(d, f, n, f.ndim)


def count_delta(target_cl, frequencies, n_measurements):
    """Smallest margin delta achieving `target_cl` confidence: bisection on
    (1e-10, 1) by 34 halvings. `target_cl` may be batched."""
    f = as_real(frequencies)
    n = as_real(n_measurements, like=f)
    target = as_real(target_cl, like=f)
    return _bisect(
        lambda mid: count_confidence(mid, f, n).reshape(target.shape), target
    )
