"""The port's examples (`quantpy_tpu_torch.examples`) against the JAX
package's examples/*.py.

In float64, on the same records: the teleportation record's 'lifp'
fidelity and moment band, and the deterministic outputs of `real_records`
(estimates, moment and Sugiyama radii, the polytope and moment-fidelity
bands), agree at 1e-8; the state record's 'mle' fidelity, an L-BFGS
estimate on both sides, at 1e-6 (held by likelihood in
tests/test_torch_cholesky_mle.py). The random workflows (fidelity sweeps,
posterior sampling) carry the assertions of tests/test_example_workflows.py
at its sizes; the other examples run end to end at small sizes, figures
off.
"""

import pathlib
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "examples"))

import quantpy_tpu as qt  # noqa: E402
import real_records as jrecords  # noqa: E402
import teleportation as jtele  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config  # noqa: E402
from quantpy_tpu_torch.examples import (  # noqa: E402
    confidence_intervals,
    fidelity_intervals,
    polytope_verification,
    posterior_sampling,
    process_tomography,
    qpt_scaling,
    real_records,
    scaling_study,
    state_tomography,
    teleportation,
)

from ._torch_cpu import on_cpu  # noqa: E402, F401

ATOL = 1e-8


@pytest.fixture
def float64():
    prev = config.rdtype()
    config.set_dtype(torch.float64)
    yield
    config.set_dtype(prev)


def test_tetrahedral_states_and_calibrated_povm_equal_jax():
    ours = np.stack([s.bloch for s in teleportation.tetrahedral_input_states()])
    ref = np.stack([np.asarray(s.bloch) for s in jtele.tetrahedral_input_states()])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-14)
    assert np.linalg.matrix_rank(ours) == 4
    povm = teleportation.calibrated_povm_matrix()
    np.testing.assert_allclose(povm, jtele.calibrated_povm_matrix(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(povm.sum(axis=1), np.tile([1.0, 0, 0, 0], (3, 1)), atol=1e-12)
    np.testing.assert_array_equal(teleportation.IBM_COUNTS, jtele.IBM_COUNTS)


def _teleportation(pkg, module):
    target = pkg.operator.Id.as_channel()
    tmg = pkg.ProcessTomograph(target, input_states=module.tetrahedral_input_states(), key=17)
    tmg.experiment(8192, module.calibrated_povm_matrix())
    tmg.results = module.IBM_COUNTS
    est = tmg.point_estimate("lifp")
    fid = float(np.dot(target.choi.bloch, est.choi.bloch))
    band = pkg.MomentFidelityProcessInterval(tmg, target_process=target)
    (fmin, fmax), _ = band(np.array([0.5, 0.95]))
    return fid, np.asarray(fmin), np.asarray(fmax)


def test_teleportation_record_matches_jax(float64):
    fid, fmin, fmax = _teleportation(qtt, teleportation)
    ref_fid, ref_min, ref_max = _teleportation(qt, jtele)
    assert abs(fid - ref_fid) <= ATOL
    np.testing.assert_allclose(fmin, ref_min, rtol=0, atol=ATOL)
    np.testing.assert_allclose(fmax, ref_max, rtol=0, atol=ATOL)
    # the published IBMQ teleportation run: clearly sub-unit but real
    assert 0.75 < fid < 0.95
    assert np.all(fmin <= fid + 0.05) and np.all(fmax >= fid - 0.05)


def test_teleportation_main_prints_the_jax_numbers(float64, capsys):
    """The three printed figures (4 decimals), polytope band included."""
    jtele.main()
    ref = capsys.readouterr().out
    teleportation.main(["--device", "cpu"])
    assert capsys.readouterr().out == ref


@pytest.fixture(scope="module")
def jax_records():
    """The JAX example's outputs on the bundled records (its bootstraps cut
    to 16 resamples: they are compared by invariants only)."""
    return jrecords.analyze_state_record(n_boot=16), jrecords.analyze_process_record(n_boot=16)


def test_real_records_match_jax(float64, jax_records):
    ref_state, ref_process = jax_records
    state = real_records.analyze_state_record(n_boot=64)
    process = real_records.analyze_process_record(n_boot=16)
    assert set(state) == set(ref_state) and set(process) == set(ref_process)
    assert abs(state["fidelity_to_target"] - ref_state["fidelity_to_target"]) <= 1e-6
    for key in ("moment_radius", "sugiyama_radius", "polytope_fidelity_band"):
        np.testing.assert_allclose(state[key], ref_state[key], rtol=0, atol=ATOL, err_msg=key)
    for key in ("entanglement_fidelity", "pgdb_vs_lifp_hs", "moment_fidelity_band"):
        np.testing.assert_allclose(process[key], ref_process[key], rtol=0, atol=ATOL,
                                   err_msg=key)
    # the assertions of tests/test_real_records.py
    assert 0.85 < state["fidelity_to_target"] < 0.995
    for key in ("moment_radius", "sugiyama_radius", "bootstrap_radius"):
        r = np.asarray(state[key])
        assert np.all(np.isfinite(r)) and np.all(r >= 0) and np.all(np.diff(r) >= -1e-9)
    fmin, fmax = np.asarray(state["polytope_fidelity_band"])
    assert np.all(fmin <= fmax + 1e-6)
    assert 0.8 < process["entanglement_fidelity"] < 0.99
    fmin, fmax = np.asarray(process["moment_fidelity_band"])
    assert fmin[-1] - 0.05 <= process["entanglement_fidelity"] <= fmax[-1] + 0.05
    r = np.asarray(process["bootstrap_radius"])
    assert np.all(np.isfinite(r)) and np.all(np.diff(r) >= -1e-9)


def test_state_fidelity_sweep_covers_truth():
    epsilons = np.logspace(-4, -0.05, 12)
    true_fid, bands = fidelity_intervals.state_fidelity_sweep(
        epsilons, n_shots=10_000, repeats=3, key0=700
    )
    assert abs(true_fid - 0.925) < 1e-9  # the notebook's headline value
    fmin = np.stack([b[0] for b in bands])
    fmax = np.stack([b[1] for b in bands])
    assert np.all(fmin <= fmax + 1e-9)
    assert np.all(fmin[:, 0] <= true_fid + 1e-6)
    assert np.all(fmax[:, 0] >= true_fid - 1e-6)


def test_process_fidelity_sweep_covers_truth():
    epsilons = np.logspace(-4, -0.05, 12)
    true_fid, bands = fidelity_intervals.process_fidelity_sweep(
        epsilons, n_shots=10_000, repeats=3, key0=900
    )
    fmin = np.stack([b[0] for b in bands])
    fmax = np.stack([b[1] for b in bands])
    assert np.all(fmin <= fmax + 1e-9)
    assert np.all(fmin[:, 0] <= true_fid + 1e-6)
    assert np.all(fmax[:, 0] >= true_fid - 1e-6)


def test_posterior_sampling_example_smoke():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # short-chain R-hat
        cd, bd, r_hat, ess = posterior_sampling.process_posterior(
            n_qubits=1, n_shots=500, n_points=80, burn_steps=200, n_boot=60
        )
        d = posterior_sampling.scipy_proposal_state_chain()
    assert np.all(np.isfinite(cd)) and np.all(np.isfinite(bd))
    assert cd[0] < 5 * bd[1] and bd[0] < 5 * max(cd[1], 1e-3)
    assert np.isfinite(r_hat) and ess > 0
    assert np.all(np.isfinite(d)) and d.shape == (2,)


@pytest.mark.parametrize("run", [
    lambda: confidence_intervals.main(["--device", "cpu"]),
    lambda: polytope_verification.main(50),
    lambda: process_tomography.main(["--device", "cpu"]),
    lambda: state_tomography.main(["--repeats", "4", "--max-qubits", "2", "--device", "cpu"]),
    lambda: scaling_study.main(3),
    lambda: qpt_scaling.main(["--qubits", "1", "--device", "cpu"]),
], ids=["confidence_intervals", "polytope_verification", "process_tomography",
        "state_tomography", "scaling_study", "qpt_scaling"])
def test_examples_run_on_the_cpu(monkeypatch, capsys, run):
    monkeypatch.setenv("EXAMPLES_FIGURES", "0")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # confidence_intervals' short chain
        run()
    out = capsys.readouterr().out
    assert out and "nan" not in out
