"""Precision and device configuration for the PyTorch port.

The default working precision is float32/complex64; float64/complex128 is
one call away (:func:`set_dtype`) and is what the parity tests against the
JAX package use. Functions in this package follow the dtype and device of
the tensors they are given; these settings are only the defaults for data
that arrives as numpy arrays or Python numbers.

Reduced-precision matrix products are switched off on import: the JAX
package measured that bf16 matmuls collapse the 4-qubit bootstrap's
distance distribution (median 0.004 -> 0.84), and TF32 is the CUDA
counterpart of that risk.

The default device is the card, ``cuda``: data that arrives as numpy arrays,
and a tomograph built without ``device=``, land there. A caller that wants
the CPU says so (``set_device("cpu")`` or an explicit ``device=``
argument). Nothing checks whether a GPU is present: on a host without CUDA
the default raises where PyTorch does for a CUDA tensor, and nothing
carries on on the CPU instead.
"""

from __future__ import annotations

import torch

__all__ = [
    "set_dtype",
    "enable_x64",
    "is_x64",
    "set_matmul_precision",
    "default_device_kind",
    "rdtype",
    "cdtype",
    "complex_dtype",
    "set_device",
    "get_device",
    "as_real",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_REAL_DTYPES = (torch.float32, torch.float64)
_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}

_dtype = torch.float32
_device = torch.device("cuda")


def set_dtype(dtype: torch.dtype) -> None:
    """Set the default real dtype (torch.float32 or torch.float64)."""
    global _dtype
    if dtype not in _REAL_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    _dtype = dtype


def enable_x64(enable: bool = True) -> None:
    """Switch the default real dtype to float64 (or back to float32), the
    JAX package's x64 mode. The card has float64, so unlike the JAX
    package's TPU guard this does not raise on a CUDA default device."""
    set_dtype(torch.float64 if enable else torch.float32)


def is_x64() -> bool:
    """Whether the default real dtype is float64."""
    return rdtype() == torch.float64


#: the JAX package's matmul precision names, as torch's float32 settings
_MATMUL_PRECISION = {
    "highest": "highest",
    "float32": "highest",
    "high": "high",
    "tensorfloat32": "high",
    "bfloat16_3x": "high",
    "default": "medium",
    "bfloat16": "medium",
}


def set_matmul_precision(precision: str = "highest") -> None:
    """Set the float32 matmul precision by the JAX package's names:
    'highest'/'float32' keep full float32 products (pinned on import),
    'high'/'tensorfloat32'/'bfloat16_3x' allow TF32, and
    'default'/'bfloat16' allow bf16 (`torch.set_float32_matmul_precision`'s
    'highest', 'high' and 'medium'). Any other name raises ValueError."""
    if precision not in _MATMUL_PRECISION:
        raise ValueError(
            f"unknown matmul precision {precision!r}; expected one of "
            f"{sorted(_MATMUL_PRECISION)}")
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[precision])


def default_device_kind() -> str:
    """Platform of the default device, by the JAX package's names: 'gpu'
    for a CUDA device, 'cpu' for the CPU."""
    kind = _device.type
    return "gpu" if kind == "cuda" else kind


def rdtype() -> torch.dtype:
    """Current default real dtype."""
    return _dtype


def cdtype() -> torch.dtype:
    """Complex dtype matching the current default real dtype."""
    return _COMPLEX_OF[_dtype]


def complex_dtype(real: torch.dtype) -> torch.dtype:
    """Complex dtype of the same precision as the real dtype `real`."""
    return _COMPLEX_OF[real]


def set_device(device) -> None:
    """Set the default device for data that arrives as numpy arrays and for
    tomographs built without ``device=``."""
    global _device
    _device = torch.device(device)


def get_device() -> torch.device:
    """Current default device (``cuda`` unless set otherwise)."""
    return _device


def as_real(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """`x` as a real tensor.

    With `like`, the result takes its dtype and device. Otherwise a real
    tensor keeps its own, and anything else (numpy arrays, numbers, integer
    tensors) gets the default dtype on its own device or the default one.
    """
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if isinstance(x, torch.Tensor):
        if x.dtype in _REAL_DTYPES:
            return x
        return x.to(_dtype)
    return torch.as_tensor(x, dtype=_dtype, device=_device)
