"""Carry a tomography experiment across packages as numpy arrays.

The system has no weights; its state is the experiment: the POVM design,
the shots per POVM, the outcome counts and the true state. A state
tomograph of the JAX package holds them as `.povm_matrix`,
`.n_measurements`, `.results` and `.state.bloch`, and in kron mode
`.povm_kron` with `.povm_matrix` None. A process tomograph holds the true
channel (`.channel.choi.bloch`), its input states, the design and shots of
its inner tomographs and the counts per input state (`.results`). These
functions rebuild a port tomograph from those arrays and give them back.
Only numpy crosses.
"""

from __future__ import annotations

import numpy as np

from .channel import Channel
from .qobj import Qobj
from .tomography.process import ProcessTomograph
from .tomography.state import StateTomograph

__all__ = ["tomograph_from_arrays", "process_tomograph_from_arrays", "to_numpy"]


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


def process_tomograph_from_arrays(
    choi_bloch, input_states, povm_matrix, n_measurements, results, *, device=None,
    dtype=None, seed=0,
) -> ProcessTomograph:
    """A port ProcessTomograph holding the true channel (its Choi bloch
    vector), the input states (stacked bloch vectors (S, 4^n)), the design,
    the shots and the counts (S, m, p), computing on `device` in `dtype`,
    seeded with `seed`; the defaults are the port's."""
    ptmg = ProcessTomograph(
        Channel(Qobj(np.array(choi_bloch, dtype=np.float64))),
        input_states=[Qobj(b) for b in np.array(input_states, dtype=np.float64)],
        key=seed, device=device, dtype=dtype,
    )
    ptmg._povm1 = None
    ptmg.tomographs = ptmg._new_tomographs()
    for tmg, counts in zip(ptmg.tomographs, np.array(results, dtype=np.float64)):
        tmg.povm_matrix = _array(povm_matrix)
        tmg.n_measurements = np.array(n_measurements, dtype=np.float64)
        tmg._results = counts
    return ptmg


def to_numpy(tmg) -> dict:
    """The experiment of a tomograph of either package as float64 numpy
    arrays, keyed by the argument names of :func:`tomograph_from_arrays`
    or, for a process tomograph, of :func:`process_tomograph_from_arrays`;
    `povm_matrix` is None in kron mode, and `povm_kron` is there where the
    tomograph has one."""
    if hasattr(tmg, "channel"):
        t0 = tmg.tomographs[0]
        return {
            "choi_bloch": _array(tmg.channel.choi.bloch),
            "input_states": np.stack([_array(s.bloch) for s in tmg.input_basis.elements]),
            "povm_matrix": _array(t0.povm_matrix),
            "n_measurements": _array(t0.n_measurements),
            "results": _array(tmg.results),
        }
    arrays = {
        "povm_matrix": _array(tmg.povm_matrix),
        "n_measurements": _array(tmg.n_measurements),
        "results": _array(tmg.results),
        "state_bloch": _array(tmg.state.bloch),
    }
    if getattr(tmg, "povm_kron", None) is not None:
        arrays["povm_kron"] = _array(tmg.povm_kron)
    return arrays
