"""The port's factored moment and Sugiyama recipes (kron_analytic) against
quantpy_tpu on the CPU, in float64.

Frequencies are drawn once with numpy and handed to both packages.
Tolerances: 1e-10 relative for the exact recipes; the Hutchinson variance
of channel_l2_moments_kron is held to 1e-10 on the JAX package's own
Rademacher probes (fed through `probes=`) and to 5% against the exact
per-state recipe on the port's own draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.measurements import _single_qubit_preset  # noqa: E402
from quantpy_tpu.tomography import kron_analytic as jka  # noqa: E402
from quantpy_tpu.tomography.process import _generate_input_states  # noqa: E402

from quantpy_tpu_torch import stats  # noqa: E402
from quantpy_tpu_torch.tomography import kron_analytic as ka  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

POVM1 = _single_qubit_preset("proj-set")
STATES1_T = np.stack([s.T.bloch for s in _generate_input_states("proj4", 1)])


def _state_freq(n, seed, shots=1000):
    """(3^n, 2^n) proj-set frequencies of a full-rank GHZ(n) mixture."""
    rng = np.random.default_rng(seed)
    povm = qt.generate_measurement_matrix("proj-set", n)
    bloch = 0.9 * qt.GHZ(n).bloch
    bloch[0] = 1 / 2**n
    probs = np.einsum("mod,d->mo", povm, bloch) * 2**n
    return np.stack([rng.multinomial(shots, q / q.sum()) for q in probs]) / shots


def _channel_experiment(n, seed, shots=3000):
    """(states_matrix, povm_matrix, freq (S, m, p)) of depolarizing(0.3, n)
    with proj4 inputs and proj-set measurements."""
    rng = np.random.default_rng(seed)
    tmg = qt.ProcessTomograph(qt.channel.depolarizing(0.3, n), key=seed)
    povm = qt.generate_measurement_matrix("proj-set", n)
    out = np.stack([np.asarray(tmg.channel.transform(s).bloch) for s in tmg.input_basis.elements])
    probs = np.clip(np.einsum("mod,sd->smo", povm, out) * 2**n, 0, None)
    freq = np.stack([
        [rng.multinomial(shots, q / q.sum()) for q in ps] for ps in probs
    ]) / shots
    return np.asarray(tmg._input_blochs_t()), povm, freq


@pytest.mark.parametrize("n, chunk", [(1, None), (2, None), (3, None), (3, 5)])
def test_kron_l2_moments_match_jax(n, chunk):
    freq = _state_freq(n, seed=30 + n)
    ours = ka.kron_l2_moments(POVM1, n, freq, 1000.0, chunk=chunk)
    ref = jka.kron_l2_moments(POVM1, n, freq, 1000.0)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_kron_l2_moments_equal_the_dense_factor_recipe():
    n = 2
    freq = _state_freq(n, seed=35)
    povm_flat = qt.generate_measurement_matrix("proj-set", n).reshape(-1, 16)
    inv = np.linalg.solve(povm_flat.T @ povm_flat, povm_flat.T) / 2**n
    dense = stats.l2_moments_from_factor(inv.reshape(16, 9, 4), freq, 1000.0)
    np.testing.assert_allclose(ka.kron_l2_moments(POVM1, n, freq, 1000.0), dense, rtol=1e-10)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_kron_sugiyama_c_alpha_matches_jax(n):
    ours = ka.kron_sugiyama_c_alpha(POVM1, n)
    assert ours.shape == (4**n,) and ours.dtype == np.float64
    np.testing.assert_allclose(ours, jka.kron_sugiyama_c_alpha(POVM1, n), rtol=1e-10)


@pytest.mark.parametrize("n", [1, 2])
def test_channel_l2_moments_match_jax(n):
    states, povm, freq = _channel_experiment(n, seed=40 + n)
    ours = ka.channel_l2_moments(states, povm, freq, 3000.0)
    ref = jka.channel_l2_moments(states, povm, freq, 3000.0)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_channel_block_grams_in_state_chunks(monkeypatch):
    states, povm, freq = _channel_experiment(2, seed=43)
    whole = ka.channel_l2_moments(states, povm, freq, 3000.0)
    monkeypatch.setattr(ka, "_CHUNK_BYTES", 8 * 16 * 36 * 3)  # 3 states per chunk
    np.testing.assert_allclose(ka.channel_l2_moments(states, povm, freq, 3000.0), whole,
                               rtol=1e-12)


def _jax_probes(n, n_probes, probe_chunk=16, seed=1234):
    """The Rademacher probes channel_l2_moments_kron of the JAX package
    draws for `key=jax.random.key(seed)`, concatenated."""
    key, out, done = jax.random.key(seed), [], 0
    while done < n_probes:
        nz = min(probe_chunk, n_probes - done)
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.rademacher(sub, (nz,) + (4,) * n, dtype=np.float64)))
        done += nz
    return np.concatenate(out)


@pytest.mark.parametrize("n", [1, 2])
def test_channel_l2_moments_kron_on_the_jax_probes(n):
    _, _, freq = _channel_experiment(n, seed=50 + n)
    ref = jka.channel_l2_moments_kron(STATES1_T, POVM1, n, freq, 3000.0, n_probes=40)
    probes = _jax_probes(n, 40)
    ours = ka.channel_l2_moments_kron(STATES1_T, POVM1, n, freq, 3000.0,
                                      probes=torch.tensor(probes))
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_channel_l2_moments_kron_against_the_exact_recipe():
    n = 2
    states, povm, freq = _channel_experiment(n, seed=55)
    mean_d, var_d = ka.channel_l2_moments(states, povm, freq, 3000.0)
    # several state chunks and a ragged last probe batch
    mean_k, var_k = ka.channel_l2_moments_kron(
        STATES1_T, POVM1, n, freq, 3000.0, n_probes=250, probe_chunk=10, key=5,
        state_chunk=5)
    np.testing.assert_allclose(mean_k, mean_d, rtol=1e-10)
    np.testing.assert_allclose(var_k, var_d, rtol=0.05)
    again = ka.channel_l2_moments_kron(
        STATES1_T, POVM1, n, freq, 3000.0, n_probes=250, probe_chunk=10, key=5,
        state_chunk=5)
    assert again == (mean_k, var_k)
