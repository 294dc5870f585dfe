"""Moments of the weighted squared L2 error ||f - p||_W^2 under the
multinomial measurement model (port of quantpy_tpu/stats.py; used by
MomentInterval).

Let x = f_obs - p be the centered outcome frequencies of m independent
multinomials with N shots each. The CLT gives x ~ N(0, Sigma / N) with the
block-diagonal multinomial covariance

    Sigma[ai, bj] = delta_ab (delta_ij f_ai - f_ai f_aj)

at the observed frequencies. For the quadratic form Q = x^T W x, Isserlis'
theorem gives

    E[Q]   = tr(W Sigma) / N
    E[Q^2] = ( tr(W Sigma)^2 + 2 tr((W Sigma)^2) ) / N^2.

When W = V^T V comes from a factor V of shape (D, m, p) (the measurement
map's pseudo-inverse in MomentInterval), with T[d, a] = sum_i V[d,ai] f[ai]
and R = V diag(f) V^T, one has V Sigma V^T = R - T T^T, hence

    E[Q] = tr(R - T T^T) / N,     Var[Q] = 2 ||R - T T^T||_F^2 / N^2.

That form (:func:`l2_moments_from_factor`) is a torch computation in
float64 on the factor's device; the weights-tensor forms are numpy, for
API parity with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import get_device

__all__ = [
    "l2_mean",
    "l2_variance",
    "l2_first_moment",
    "l2_second_moment",
    "l2_moments_from_factor",
    "make_identity_weights",
]


def make_identity_weights(freq: np.ndarray) -> np.ndarray:
    """Identity weights tensor W[ai, bj] = delta_ab delta_ij for an (m, p)
    frequency table."""
    m, p = np.asarray(freq).shape
    return np.einsum("ab,ij->aibj", np.eye(m), np.eye(p))


def _w_sigma(weights: np.ndarray, freq: np.ndarray) -> np.ndarray:
    """The (mp, mp) matrix W Sigma with Sigma the block-diagonal multinomial
    covariance at plug-in frequencies f."""
    m, p = freq.shape
    w = np.asarray(weights, dtype=np.float64).reshape(m * p, m * p)
    f = np.asarray(freq, dtype=np.float64)
    # (W Sigma)[ai, bj] = W[ai,bj] f[bj] - (sum_k W[ai,bk] f[bk]) f[bj]
    w4 = w.reshape(m * p, m, p)
    wf = np.einsum("xbk,bk->xb", w4, f)
    ws = w4 * f[None, :, :] - wf[:, :, None] * f[None, :, :]
    return ws.reshape(m * p, m * p)


def l2_first_moment(freq, n_trials, weights) -> float:
    """E ||f - p||_W^2 = tr(W Sigma) / N."""
    return float(np.trace(_w_sigma(weights, freq))) / n_trials


def l2_second_moment(freq, n_trials, weights) -> float:
    """E (||f - p||_W^2)^2 = (tr(W Sigma)^2 + 2 tr((W Sigma)^2)) / N^2."""
    ws = _w_sigma(weights, freq)
    t = np.trace(ws)
    t2 = float(np.sum(ws * ws.T))  # tr((W Sigma)^2) without the product
    return (t * t + 2.0 * t2) / n_trials**2


def l2_moments_from_factor(v, freq, n_trials) -> tuple[float, float]:
    """(mean, variance) of ||f - p||_W^2 for W = V^T V, without forming W.

    Parameters
    ----------
    v : (D, m, p) real factor, a tensor (its device is used) or an array
        (moved to the default device)
    freq : (m, p) observed frequencies
    n_trials : shots per POVM

    Computed in float64: mean = tr(R - T T^T)/N and variance =
    2 ||R - T T^T||_F^2 / N^2 with R = V diag(f) V^T and T = V f
    contracted per POVM.
    """
    device = v.device if isinstance(v, torch.Tensor) else get_device()
    v = torch.as_tensor(v, dtype=torch.float64, device=device)
    f = torch.as_tensor(freq, dtype=torch.float64, device=device)
    v2 = v.reshape(v.shape[0], -1)
    r = (v2 * f.reshape(-1)) @ v2.T
    t = (v * f).sum(-1)
    m = r - t @ t.T
    trace, fro2 = torch.stack([torch.trace(m), torch.sum(m * m)]).tolist()
    return trace / n_trials, 2.0 * fro2 / n_trials**2


def l2_mean(freq, n_trials, weights=None) -> float:
    """Mean of ||f - p||_W^2 (identity weights by default)."""
    freq = np.asarray(freq, dtype=np.float64)
    if weights is None:
        weights = make_identity_weights(freq)
    return l2_first_moment(freq, n_trials, weights)


def l2_variance(freq, n_trials, weights=None) -> float:
    """Variance of ||f - p||_W^2 (identity weights by default)."""
    freq = np.asarray(freq, dtype=np.float64)
    if weights is None:
        weights = make_identity_weights(freq)
    return l2_second_moment(freq, n_trials, weights) - l2_first_moment(
        freq, n_trials, weights
    ) ** 2
