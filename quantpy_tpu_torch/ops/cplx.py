"""Real <-> complex packing (port of quantpy_tpu/ops/cplx.py).

The JAX package moves non-Hermitian complex data (gates, kets, Kraus and
Choi factors) across its jit boundaries as real arrays with a trailing
re/im axis of size 2, because its TPU backend cannot transfer complex
arrays. Torch moves complex tensors to and from the card directly; these
helpers keep the pair convention for code and files written against the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import get_device, rdtype

__all__ = ["to_pair", "from_pair", "pair_to_complex", "complex_to_pair"]


def to_pair(array) -> torch.Tensor:
    """A complex numpy array or tensor as a real (..., 2) tensor of the
    default dtype on the default device."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    a = np.asarray(array)
    return torch.as_tensor(np.stack([a.real, a.imag], axis=-1), dtype=rdtype(),
                           device=get_device())


def from_pair(pair) -> np.ndarray:
    """A real (..., 2) array or tensor back as a numpy complex array."""
    if isinstance(pair, torch.Tensor):
        pair = pair.detach().cpu().numpy()
    p = np.asarray(pair)
    return p[..., 0] + 1j * p[..., 1]


def pair_to_complex(pair: torch.Tensor) -> torch.Tensor:
    """A real (..., 2) tensor viewed as a complex tensor (...)."""
    return torch.view_as_complex(pair.contiguous())


def complex_to_pair(z: torch.Tensor) -> torch.Tensor:
    """A complex tensor as a real (..., 2) tensor (a view unless `z` is a
    lazily conjugated view)."""
    return torch.view_as_real(z.resolve_conj())
