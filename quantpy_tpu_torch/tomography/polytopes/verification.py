"""Monte-Carlo coverage verification of confidence polytopes (port of
quantpy_tpu/tomography/polytopes/verification.py).

Repeat the experiment many times and count how often the TRUE state or
process satisfies every polytope inequality at each nominal confidence
level. Two steps: :func:`simulate_frequencies` draws every trial at once,
and :func:`coverage_of` runs the (trial, level) bisections of the polytope
margin and the membership test on given frequencies, in chunks of trials
sized by bytes, every level and bisection of a chunk at once.
:func:`coverage_hits` is the two in turn.

The functions named `test_*` are the reference's names; a test module that
imports them aliases them, or pytest collects them as tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import as_real, get_device, rdtype
from ...measurements import generate_measurement_matrix
from .. import state_core
from ..state import make_generator
from .utils import _bisect, _confidence

__all__ = [
    "test_qst",
    "test_qpt",
    "qst_problem",
    "qpt_problem",
    "coverage_hits",
    "coverage_of",
    "simulate_frequencies",
]

_EPS = 1e-15
#: elements of one (trials x levels x outcomes) work tensor of coverage_of
_CHUNK_ELEMENTS = 1 << 26


def simulate_frequencies(generator, povm_matrix, n_meas, sim_blochs, n_trials: int):
    """Clipped outcome frequencies (n_trials, [S,] m, p) of `n_trials`
    simulated experiments on `sim_blochs` ((4^n,) for a state, (S, 4^n)
    for the output states of a process), on the device and in the dtype of
    `sim_blochs` (numpy: the port's defaults); `generator` lives there."""
    blochs = as_real(sim_blochs)
    n_meas = as_real(n_meas, like=blochs)
    blochs = blochs.expand((n_trials,) + tuple(blochs.shape))
    counts = state_core.simulate_experiment(
        generator, as_real(povm_matrix, like=blochs), blochs, n_meas
    )
    return torch.clamp(counts / n_meas[:, None], _EPS, 1 - _EPS)


def coverage_of(freq, n_meas, polytope_prod, base_offset, conf_levels, clip_b: bool):
    """Per-level HIT COUNTS (L,) as int64 numpy over the trials of `freq`
    (n_trials, [S,] m, p): for each (trial, level), whether
    min(b - polytope_prod) > -EPS with b = freq + delta(level) (clipped to
    [EPS, 1 - EPS] if `clip_b`) - base_offset. Computes in the dtype and on
    the device of `freq`."""
    freq = as_real(freq)
    n_meas = as_real(n_meas, like=freq)
    prod = as_real(polytope_prod, like=freq)
    offset = as_real(base_offset, like=freq)
    levels = as_real(conf_levels, like=freq).reshape(-1)
    n_trials, n_levels = freq.shape[0], levels.shape[0]
    n_event = freq.ndim - 1
    per_trial = freq[0].numel()
    chunk = max(1, _CHUNK_ELEMENTS // (n_levels * per_trial))
    hits = torch.zeros(n_levels, dtype=torch.int64, device=freq.device)
    for lo in range(0, n_trials, chunk):
        f = freq[lo : lo + chunk]
        f_lv = f[:, None]  # (T, 1, [S,] m, p): every level of a trial
        target = levels.expand(f.shape[0], n_levels)

        def confidence(mid):
            return _confidence(mid.reshape(mid.shape + (1,) * n_event), f_lv, n_meas, n_event)

        delta = _bisect(confidence, target)  # (T, L)
        b = f.reshape(f.shape[0], 1, per_trial) + delta[..., None]
        if clip_b:
            b = torch.clamp(b, _EPS, 1 - _EPS)
        b = b - offset
        hits += (torch.amin(b - prod, dim=-1) > -_EPS).sum(0)
    return hits.cpu().numpy()


def coverage_hits(
    generator, povm_matrix, n_meas, sim_blochs, polytope_prod, base_offset, conf_levels,
    n_trials: int, clip_b: bool,
):
    """Per-level hit counts (L,) over `n_trials` simulated experiments:
    :func:`simulate_frequencies`, then :func:`coverage_of`."""
    freq = simulate_frequencies(generator, povm_matrix, n_meas, sim_blochs, n_trials)
    return coverage_of(freq, n_meas, polytope_prod, base_offset, conf_levels, clip_b)


def qst_problem(state, n_measurements):
    """Static arrays of the QST coverage problem: (povm_matrix, n_meas,
    sim_blochs, polytope_prod, base_offset, clip_b), float64 numpy."""
    dim = 2**state.n_qubits
    povm_matrix = generate_measurement_matrix("proj-set", state.n_qubits)
    m = povm_matrix.shape[0]
    n_meas = np.full(m, n_measurements, dtype=np.float64)

    povm_flat = (
        povm_matrix * n_meas[:, None, None] / n_meas.sum()
    ).reshape(-1, povm_matrix.shape[-1]) * m
    a_matrix = povm_flat[:, 1:] * dim
    polytope_prod = a_matrix @ np.asarray(state.bloch[1:])
    base_offset = povm_flat[:, 0]
    return (
        povm_matrix,
        n_meas,
        np.asarray(state.bloch, dtype=np.float64),
        polytope_prod,
        base_offset,
        True,
    )


def qpt_problem(channel, n_measurements, input_states="sic"):
    """Static arrays of the QPT coverage problem (the tuple layout of
    :func:`qst_problem`)."""
    from ..process import ProcessTomograph

    tmg = ProcessTomograph(channel, input_states=input_states, device="cpu")
    n = channel.n_qubits
    dim = 4**n

    povm_matrix = generate_measurement_matrix("proj-set", n)
    m = povm_matrix.shape[0]
    n_meas = np.full(m, n_measurements, dtype=np.float64)

    meas_flat = (
        povm_matrix * n_meas[:, None, None] / n_meas.sum()
    ).reshape(-1, povm_matrix.shape[-1]) * m
    states_matrix = tmg._input_blochs_t()
    # the constraint rows factor as a[(s,j)] = dim * b_s (x) w_j with the
    # W-side identity component dropped (every (a, b) with b > 0), so
    # A @ x never needs the materialized (S*K, dim^2 - dim) operator
    choi_rect = np.asarray(channel.choi.bloch).reshape(dim, dim)[:, 1:]
    polytope_prod = (dim * states_matrix @ choi_rect @ meas_flat[:, 1:].T).reshape(-1)
    base_offset = np.tile(meas_flat[:, 0], states_matrix.shape[0])

    out_blochs = np.stack([channel.transform(s).bloch for s in tmg.input_basis.elements])
    return povm_matrix, n_meas, out_blochs, polytope_prod, base_offset, False


def _coverage(problem, conf_levels, n_trials, key):
    povm, n_meas, sim_blochs, prod, offset, clip_b = problem
    device = get_device()
    blochs = torch.as_tensor(sim_blochs, dtype=rdtype(), device=device)
    sums = coverage_hits(
        make_generator(key, device), povm, n_meas, blochs, prod, offset, conf_levels,
        n_trials, clip_b,
    )
    return sums.astype(np.float64) / n_trials


def test_qst(state, conf_levels, n_measurements=1000, n_trials=1000, key=None):
    """Empirical coverage of the state confidence polytope: per-level
    coverage in [0, 1], computed on the port's default device in its
    working dtype. `key` is an int seed or a torch.Generator on that
    device (default: seed 0)."""
    return _coverage(qst_problem(state, n_measurements), conf_levels, n_trials,
                     0 if key is None else key)


def test_qpt(channel, conf_levels, n_measurements=1000, n_trials=1000,
             input_states="sic", key=None):
    """Empirical coverage of the process confidence polytope (default
    seed 1)."""
    return _coverage(qpt_problem(channel, n_measurements, input_states), conf_levels,
                     n_trials, 1 if key is None else key)
