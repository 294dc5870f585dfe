"""The plain reference against the program at tiny sizes on the CPU:
GHZ-2 lin and RrhoR in float32 and float64, and 1- and 2-qubit
depolarizing channels on SIC inputs: their action, lifp, and the CPTP
projection with the interval's stop rule."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import quantpy_tpu_torch as qt
from benchmark.reference import paulis, process, state
from quantpy_tpu_torch.measurements import generate_measurement_matrix
from quantpy_tpu_torch.ops import paulis as program_paulis
from quantpy_tpu_torch.tomography import bootstrap_core, process_core, state_core

TOL = {torch.float64: 1e-12, torch.float32: 2e-5}


@pytest.mark.parametrize("n", [1, 2, 3])
def test_pauli_transforms(n):
    b = torch.randn(3, 4**n, dtype=torch.float64)
    m = paulis.bloch_to_matrix(b, n)
    assert torch.allclose(m, program_paulis.bloch_to_matrix(b, n), atol=1e-14)
    assert torch.allclose(paulis.matrix_to_bloch(m, n), b, atol=1e-14)
    assert np.array_equal(paulis.transpose_signs(n), program_paulis.pauli_transpose_signs(n))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_designs_and_states(n):
    assert np.array_equal(state.proj_set_povm(n), generate_measurement_matrix("proj-set", n))
    assert np.allclose(state.ghz_bloch(n), qt.GHZ(n).bloch, atol=1e-15)
    ins = process.sic_inputs(n)
    ptmg = qt.ProcessTomograph(qt.depolarizing(0.1, n), input_states="sic", device="cpu")
    assert np.allclose(ins, np.stack([s.bloch for s in ptmg.input_basis.elements]), atol=1e-15)
    # the channel's action, from its Choi bloch vector
    choi = np.asarray(qt.depolarizing(0.1, n).choi.bloch, dtype=np.float64)
    assert np.allclose(process.channel_outputs(choi, ins, n), process.depolarized(ins, 0.1),
                       atol=1e-14)


def _ghz2_counts(batch=32, shots=1000, seed=3):
    povm = state.proj_set_povm(2)
    probs = state.probabilities(povm, state.ghz_bloch(2))
    return povm, state.draw_counts(np.random.default_rng(seed), np.stack([probs] * batch), shots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_state_estimators(dtype):
    povm, counts = _ghz2_counts()
    c = torch.as_tensor(counts, dtype=dtype)
    p = torch.as_tensor(povm, dtype=dtype)
    shots = torch.full((9,), 1000.0, dtype=dtype)
    w = state.design(povm, 1000, dtype, "cpu")
    f = state.frequencies(c)
    lin = state.lin(f, w, 2)
    assert (lin - state_core.estimate_lin(c, p, shots)).abs().max() < TOL[dtype]
    # the batch's fixed iterations (no stop), as the kernel runs them
    rhor = state.estimate(f, w, 2, "mle-rhor", 20)
    program = state_core.estimate_mle_rhor(c, p, shots, max_iter=20, tol=-1.0)
    assert (rhor - program).abs().max() < TOL[dtype]
    d = state.hs_distance(rhor, rhor[0], 2)
    assert (d - bootstrap_core._distance_batch("hs", rhor, rhor[0], 2)).abs().max() < TOL[dtype]


def test_point_estimate_stop():
    """One experiment's RrhoR with the point estimate's stop rule."""
    povm, counts = _ghz2_counts(batch=1)
    tmg = qt.StateTomograph(qt.GHZ(2), device="cpu", dtype=torch.float64)
    tmg.experiment(1000, "proj-set")
    tmg.results = counts[0]
    est = tmg.point_estimate("mle-rhor", max_iter=100, tol=1e-3)
    w = state.design(povm, 1000, torch.float64, "cpu")
    f = state.frequencies(torch.as_tensor(counts[0]))
    ref = state.estimate(f, w, 2, "mle-rhor", 100, 1e-6)
    assert np.abs(ref.numpy() - est.bloch).max() < 1e-12


def test_quantiles_are_the_intervals():
    povm, counts = _ghz2_counts(batch=1)
    tmg = qt.StateTomograph(qt.GHZ(2), device="cpu", dtype=torch.float64)
    tmg.experiment(1000, "proj-set")
    tmg.results = counts[0]
    tmg.point_estimate("lin")
    iv = qt.BootstrapStateInterval(tmg, n_points=100, key=4)
    levels = [0.5, 0.9, 0.95]
    assert np.allclose(iv(levels)[0], state.quantiles(iv.distances, levels), atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2])
def test_process_estimators(dtype, n):
    ins = process.sic_inputs(n)
    povm = state.proj_set_povm(n)
    probs = state.probabilities(povm, process.depolarized(ins, 0.1))
    counts = state.draw_counts(np.random.default_rng(5), np.stack([probs] * 6), 1000)
    c = torch.as_tensor(counts, dtype=dtype)
    ptmg = qt.ProcessTomograph(qt.depolarizing(0.1, n), input_states="sic", device="cpu",
                               dtype=dtype)
    ptmg.experiment(1000)
    _, bt, p, shots = ptmg._design()
    w = state.design(povm, 1000, dtype, "cpu")
    raw = process.lifp(c, ins, w, n)
    program_raw = process_core.estimate_lifp_factored(c, bt, p, shots, cptp=False)
    assert (raw - program_raw).abs().max() < TOL[dtype]
    # the whole batch projected until its largest criterion is under tol,
    # as the interval projects a call's resamples
    tol = process_core.default_cptp_tol(1e-11, dtype)
    m, its = process.dykstra(process.choi_to_matrix(raw, n), n, process.cp_project_eigh, 2000, tol)
    program = process_core.cptp_project_bloch(program_raw, 2000, tol, "eigh")
    assert 1 < its < 2000
    assert (process.matrix_to_choi(m, n) - program).abs().max() < 50 * TOL[dtype]


def test_process_interval_is_the_references():
    """The interval's distances on the CPU in float64 are the reference's,
    from the counts its sampler drew."""
    from benchmark.entries import process_interval

    n = 1
    ptmg = qt.ProcessTomograph(qt.depolarizing(0.1, n), input_states="sic", key=2, device="cpu",
                               dtype=torch.float64)
    ptmg.experiment(1000, "proj-set")
    ptmg.point_estimate("lifp")
    iv = qt.BootstrapProcessInterval(ptmg, n_points=16, key=3, cp_engine="eigh", cptp_iter=2000)
    counts = iv.simulate(torch.Generator().manual_seed(7))
    drawn = iv.distances_of(counts)
    cfg = {"n_qubits": n, "dtype": "float64", "cptp_tol": 1e-11}
    ins = process.sic_inputs(n)
    w = state.design(state.proj_set_povm(n), 1000, torch.float64, "cpu")
    m, _ = process.dykstra(process.choi_to_matrix(process.lifp(counts, ins, w, n), n), n,
                           process.cp_project_eigh, 2000, process_interval.floored_tol(1e-11, cfg))
    center = torch.as_tensor(ptmg.reconstructed_channel.choi.bloch, dtype=torch.float64)
    ref = state.hs_distance(process.matrix_to_choi(m, n), center, 2 * n).numpy()
    assert np.abs(ref - drawn).max() < 1e-12
