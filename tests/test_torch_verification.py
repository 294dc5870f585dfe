"""The port's coverage harness of the confidence polytopes against
quantpy_tpu on the CPU, in float64.

The problems' arrays must agree to 1e-12. The hit counts of
`coverage_of` on the frequencies that the JAX harness simulates for one
key must equal the JAX package's counts exactly; the port's own
`test_qst`/`test_qpt` runs are held to the JAX tests' coverage checks.
The harness functions are named `test_*`, so they are imported under
other names here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.channel import depolarizing  # noqa: E402
from quantpy_tpu.tomography import state_core as jcore  # noqa: E402
from quantpy_tpu.tomography.polytopes import verification as jver  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch.tomography.polytopes import verification as ver  # noqa: E402
from quantpy_tpu_torch.tomography.polytopes.verification import (  # noqa: E402
    test_qpt as coverage_qpt,
    test_qst as coverage_qst,
)

from ._torch_cpu import on_cpu  # noqa: E402, F401

F64 = torch.float64


def _problems(kind, shots):
    if kind == "qst":
        return ver.qst_problem(qtt.GHZ(2), shots), jver.qst_problem(qt.GHZ(2), shots)
    channel = qtt.depolarizing(0.3, 1 if kind == "qpt1" else 2)
    ref_channel = depolarizing(0.3, 1 if kind == "qpt1" else 2)
    return ver.qpt_problem(channel, shots, "sic"), jver.qpt_problem(ref_channel, shots, "sic")


@pytest.mark.parametrize("kind", ["qst", "qpt1", "qpt2"])
def test_problems_match_jax(kind):
    ours, ref = _problems(kind, 700)
    for a, b in zip(ours[:5], ref[:5]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-14)
    assert ours[5] is ref[5]


def _jax_frequencies(problem, n_trials, seed):
    """The clipped frequencies the JAX harness simulates for
    `jax.random.key(seed)` (its coverage_hits draws them the same way)."""
    povm, n_meas, sim_blochs, *_ = problem
    blochs = jnp.broadcast_to(jnp.asarray(sim_blochs), (n_trials,) + np.shape(sim_blochs))
    counts = jcore.simulate_experiment(
        jax.random.key(seed), jnp.asarray(povm), blochs, jnp.asarray(n_meas))
    return np.clip(np.asarray(counts) / n_meas[:, None], 1e-15, 1 - 1e-15)


@pytest.mark.parametrize("kind, chunk", [("qst", None), ("qst", 3000), ("qpt1", None)])
def test_coverage_of_jax_frequencies_equals_jax_hits(kind, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(ver, "_CHUNK_ELEMENTS", chunk)  # several chunks of trials
    levels = np.array([0.2, 0.5, 0.8, 0.95])
    n_trials = 120
    _, problem = _problems(kind, 300)
    povm, n_meas, sim_blochs, prod, offset, clip_b = problem
    ref = jver.coverage_hits(jax.random.key(3), povm, n_meas, sim_blochs, prod, offset,
                             jnp.asarray(levels), n_trials, clip_b)
    freq = torch.as_tensor(_jax_frequencies(problem, n_trials, 3), dtype=F64)
    ours = ver.coverage_of(freq, n_meas, prod, offset, levels, clip_b)
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, np.asarray(ref).astype(np.int64))
    assert 0 < ours[-1] <= n_trials


def test_qst_coverage_ghz():
    """Polytope coverage dominates the nominal level (the bound is
    conservative), the JAX test's check."""
    conf_levels = np.array([0.5, 0.8, 0.95])
    cov = coverage_qst(qtt.GHZ(2), conf_levels, n_measurements=500, n_trials=300)
    assert cov.shape == (3,)
    assert np.all(cov >= conf_levels - 0.05)
    assert np.all(np.diff(cov) >= -0.05)


def test_qpt_coverage_depolarizing():
    conf_levels = np.array([0.5, 0.9])
    cov = coverage_qpt(qtt.depolarizing(0.4), conf_levels, n_measurements=500,
                       n_trials=200, input_states="sic")
    assert np.all(cov >= conf_levels - 0.07)


def test_harness_follows_the_key_and_the_dtype():
    levels = np.array([0.5, 0.9])
    a = coverage_qst(qtt.GHZ(1), levels, n_measurements=200, n_trials=50, key=4)
    b = coverage_qst(qtt.GHZ(1), levels, n_measurements=200, n_trials=50,
                     key=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a, b)
    freq = ver.simulate_frequencies(torch.Generator().manual_seed(1),
                                    *ver.qst_problem(qtt.GHZ(1), 200)[:2],
                                    torch.as_tensor(qtt.GHZ(1).bloch, dtype=torch.float32), 7)
    assert freq.shape == (7, 3, 2) and freq.dtype == torch.float32
    assert float(freq.min()) > 0 and float(freq.max()) <= 1
