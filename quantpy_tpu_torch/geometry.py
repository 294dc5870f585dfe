"""Compatibility alias of quantpy_tpu/geometry.py (the reference's
`quantpy.geometry` import path).

The distance functions live in `quantpy_tpu_torch.ops.geometry` (numpy on
host objects, torch on tensors); this module re-exports them.
"""

from .ops.geometry import (  # noqa: F401
    DISTANCES,
    fidelity,
    hs_dst,
    if_dst,
    product,
    resolve_distance,
    trace_dst,
)

__all__ = ["hs_dst", "trace_dst", "if_dst", "product", "fidelity"]
