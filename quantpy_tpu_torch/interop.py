"""Carry a state-tomography experiment across packages as numpy arrays.

The system has no weights; its state is the experiment: the POVM design,
the shots per POVM, the outcome counts and the true state. A tomograph of
the JAX package holds them as `.povm_matrix`, `.n_measurements`,
`.results` and `.state.bloch`; these functions rebuild a port tomograph
from those arrays and give them back. Only numpy crosses.
"""

from __future__ import annotations

import numpy as np

from .qobj import Qobj
from .tomography.state import StateTomograph

__all__ = ["tomograph_from_arrays", "to_numpy"]


def tomograph_from_arrays(
    povm_matrix, n_measurements, results, state_bloch, *, device=None, dtype=None, seed=0
) -> StateTomograph:
    """A port StateTomograph holding the given design, counts and true
    state, computing on `device` in `dtype`, seeded with `seed`. The
    defaults are the port's (`config.get_device()`, `config.rdtype()`), as
    for `StateTomograph`."""
    tmg = StateTomograph(
        Qobj(np.array(state_bloch, dtype=np.float64)),
        key=seed, device=device, dtype=dtype,
    )
    tmg.povm_matrix = np.array(povm_matrix, dtype=np.float64)
    tmg.n_measurements = np.array(n_measurements, dtype=np.float64)
    tmg._results = np.array(results, dtype=np.float64)
    return tmg


def to_numpy(tmg) -> dict:
    """The experiment of a tomograph as float64 numpy arrays, keyed by the
    argument names of :func:`tomograph_from_arrays`."""
    return {
        "povm_matrix": np.asarray(tmg.povm_matrix, dtype=np.float64),
        "n_measurements": np.asarray(tmg.n_measurements, dtype=np.float64),
        "results": np.asarray(tmg.results, dtype=np.float64),
        "state_bloch": np.asarray(tmg.state.bloch, dtype=np.float64),
    }
