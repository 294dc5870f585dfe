"""Carry a state-tomography experiment across packages as numpy arrays.

The system has no weights; its state is the experiment: the POVM design,
the shots per POVM, the outcome counts and the true state. A tomograph of
the JAX package holds them as `.povm_matrix`, `.n_measurements`,
`.results` and `.state.bloch`, and in kron mode `.povm_kron` with
`.povm_matrix` None; these functions rebuild a port tomograph from those
arrays and give them back. Only numpy crosses.
"""

from __future__ import annotations

import numpy as np

from .qobj import Qobj
from .tomography.state import StateTomograph

__all__ = ["tomograph_from_arrays", "to_numpy"]


def _array(x):
    return None if x is None else np.array(x, dtype=np.float64)


def tomograph_from_arrays(
    povm_matrix, n_measurements, results, state_bloch, *, povm_kron=None, device=None,
    dtype=None, seed=0,
) -> StateTomograph:
    """A port StateTomograph holding the given design, counts and true
    state, computing on `device` in `dtype`, seeded with `seed`. The
    defaults are the port's (`config.get_device()`, `config.rdtype()`), as
    for `StateTomograph`. A kron-mode experiment passes its (m1, p1, 4)
    block as `povm_kron` and None as `povm_matrix`."""
    tmg = StateTomograph(
        Qobj(np.array(state_bloch, dtype=np.float64)),
        key=seed, device=device, dtype=dtype,
    )
    tmg.povm_matrix = _array(povm_matrix)
    tmg.povm_kron = _array(povm_kron)
    tmg.n_measurements = np.array(n_measurements, dtype=np.float64)
    tmg._results = np.array(results, dtype=np.float64)
    return tmg


def to_numpy(tmg) -> dict:
    """The experiment of a tomograph as float64 numpy arrays, keyed by the
    argument names of :func:`tomograph_from_arrays`; `povm_matrix` is None
    in kron mode, and `povm_kron` is there where the tomograph has one."""
    arrays = {
        "povm_matrix": _array(tmg.povm_matrix),
        "n_measurements": _array(tmg.n_measurements),
        "results": _array(tmg.results),
        "state_bloch": _array(tmg.state.bloch),
    }
    if getattr(tmg, "povm_kron", None) is not None:
        arrays["povm_kron"] = _array(tmg.povm_kron)
    return arrays
