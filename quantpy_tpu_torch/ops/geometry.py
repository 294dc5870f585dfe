"""Distances between quantum objects (port of quantpy_tpu/ops/geometry.py).

Batched and eigh-based. Every function is polymorphic: numpy arrays (or
objects exposing `.matrix`, such as Qobj) in, numpy out; torch tensors in,
torch out on the tensors' device. All functions accept leading batch
dimensions, and distances below SNAP_EPS are snapped to zero.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "hs_dst",
    "trace_dst",
    "if_dst",
    "product",
    "fidelity",
    "resolve_distance",
    "SNAP_EPS",
]

SNAP_EPS = 1e-15


def _operands(a, b):
    """Matrices of `a` and `b`, both torch if either is a tensor."""
    a, b = getattr(a, "matrix", a), getattr(b, "matrix", b)
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        like = a if isinstance(a, torch.Tensor) else b
        return torch.as_tensor(a, device=like.device), torch.as_tensor(b, device=like.device)
    return np.asarray(a), np.asarray(b)


def _snap(d):
    if isinstance(d, torch.Tensor):
        return torch.where(d < SNAP_EPS, torch.zeros_like(d), d)
    return np.where(d < SNAP_EPS, np.zeros_like(d), d)


def hs_dst(a, b):
    """Hilbert-Schmidt distance ||A - B||_F / sqrt(2)."""
    a, b = _operands(a, b)
    diff = a - b
    if isinstance(diff, torch.Tensor):
        d = torch.sqrt(torch.sum(diff.abs() ** 2, dim=(-2, -1)) / 2.0)
    else:
        d = np.sqrt(np.sum(np.abs(diff) ** 2, axis=(-2, -1)) / 2.0)
    return _snap(d)


def trace_dst(a, b):
    """Trace distance |A - B|_1 / 2 via the eigenvalues of the difference."""
    a, b = _operands(a, b)
    diff = a - b
    if isinstance(diff, torch.Tensor):
        d = torch.linalg.eigvalsh(diff).abs().sum(-1) / 2.0
    else:
        d = np.sum(np.abs(np.linalg.eigvalsh(diff)), axis=-1) / 2.0
    return _snap(d)


def _sqrtm_psd(a):
    """Square root of a Hermitian PSD matrix via eigh (batched)."""
    if isinstance(a, torch.Tensor):
        evals, evecs = torch.linalg.eigh(a)
        sq = evals.clamp(min=0.0).sqrt().to(a.dtype)
        return (evecs * sq[..., None, :]) @ evecs.conj().transpose(-1, -2)
    evals, evecs = np.linalg.eigh(a)
    sq = np.sqrt(np.clip(evals, 0.0, None)).astype(a.dtype)
    return (evecs * sq[..., None, :]) @ np.swapaxes(evecs.conj(), -1, -2)


def fidelity(a, b):
    """Uhlmann fidelity F(A, B) = (Tr sqrt(sqrt(A) B sqrt(A)))^2."""
    a, b = _operands(a, b)
    sa = _sqrtm_psd(a)
    m = sa @ b @ sa
    if isinstance(m, torch.Tensor):
        return torch.linalg.eigvalsh(m).clamp(min=0.0).sqrt().sum(-1) ** 2
    return np.sum(np.sqrt(np.clip(np.linalg.eigvalsh(m), 0.0, None)), axis=-1) ** 2


def if_dst(a, b):
    """Infidelity 1 - F(A, B)."""
    return _snap(1.0 - fidelity(a, b))


def product(a, b):
    """Hermitian inner product Tr(A B^H) = sum_ij A_ij conj(B_ij)."""
    a, b = _operands(a, b)
    if isinstance(a, torch.Tensor):
        return (a * b.conj()).sum(dim=(-2, -1))
    return np.sum(a * b.conj(), axis=(-2, -1))


DISTANCES = {"hs": hs_dst, "trace": trace_dst, "if": if_dst}


def resolve_distance(dst):
    """Map a distance name or callable to a callable."""
    if callable(dst):
        return dst
    try:
        return DISTANCES[dst]
    except KeyError:
        raise ValueError("Invalid value for argument `dst`") from None
