"""Port parity for the kron-factored paths, the kron-mode tomograph and
interval, the dense RrhoR loop above 6 qubits, and the rule that sends
RrhoR calls to the fused kernel.

Inputs are drawn once with numpy and handed to both packages, in float64;
tolerances are those of tests/test_kron_core.py (1e-10 for the chains and
the likelihood, 1e-8 for lin, 1e-7 for RrhoR). Kron mode is forced at 2-3
qubits by lowering `StateTomograph.DENSE_POVM_MAX_ELEMENTS` in both
packages.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.measurements import _single_qubit_preset  # noqa: E402
from quantpy_tpu.ops import cholesky as jchol  # noqa: E402
from quantpy_tpu.tomography import bootstrap_core as jboot  # noqa: E402
from quantpy_tpu.tomography import kron_core as jkron  # noqa: E402
from quantpy_tpu.tomography import state_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import interop  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.tomography import bootstrap_core, kron_core, state_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

POVM1 = _single_qubit_preset("proj-set")
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _counts(n, batch, seed, shots=1000):
    """Multinomial counts of a full-rank GHZ(n) mixture, (batch, 3^n, 2^n)."""
    rng = np.random.default_rng(seed)
    povm = qt.generate_measurement_matrix("proj-set", n)
    bloch = 0.9 * qt.GHZ(n).bloch
    bloch[0] = 1 / 2**n
    probs = np.einsum("mod,d->mo", povm, bloch) * 2**n
    probs = probs / probs.sum(-1, keepdims=True)
    counts = np.stack(
        [[rng.multinomial(shots, p) for p in probs] for _ in range(batch)]
    ).astype(np.float64)
    return counts, povm, np.full(povm.shape[0], float(shots))


@pytest.fixture
def kron_budget(monkeypatch):
    """Both packages' tomographs take kron mode from 2 qubits up."""
    monkeypatch.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)
    monkeypatch.setattr(qtt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_chains_match_dense_and_jax(n):
    """n = 4 and 5 run two groups, (2, 2) and (3, 2)."""
    rng = np.random.default_rng(n)
    povm = qt.generate_measurement_matrix("proj-set", n)
    bloch = np.stack([qt.GHZ(n).bloch, rng.normal(size=4**n) / 4**n])
    c = rng.random((2, 3**n, 2**n))
    probs = kron_core.kron_probs(POVM1, n, _t(bloch))
    assert probs.shape == (2, 3**n, 2**n)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jkron.kron_probs(POVM1, n, bloch)),
                               atol=1e-10)
    np.testing.assert_allclose(
        probs.numpy(), state_core.experiment_probabilities(_t(povm), _t(bloch)).numpy(),
        atol=1e-10,
    )
    adj = kron_core.kron_apply_adjoint(POVM1, n, _t(c))
    np.testing.assert_allclose(adj.numpy(), np.asarray(jkron.kron_apply_adjoint(POVM1, n, c)),
                               atol=1e-10)
    np.testing.assert_allclose(adj.numpy(), np.einsum("zmp,mpd->zd", c, povm), atol=1e-10)
    flat = kron_core.kron_forward_flat(POVM1, n, _t(bloch))
    np.testing.assert_allclose(flat.numpy(), bloch @ povm.reshape(-1, 4**n).T, atol=1e-10)
    np.testing.assert_allclose(
        kron_core.kron_adjoint_flat(POVM1, n, _t(c.reshape(2, -1))).numpy(), adj.numpy(),
        atol=1e-12,
    )
    np.testing.assert_allclose(kron_core.kron_row_component(POVM1, n),
                               jkron.kron_row_component(POVM1, n), atol=0)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("physical", [False, True])
def test_lin_matches_dense_and_jax(n, physical):
    counts, povm, n_meas = _counts(n, 4, seed=3 + n)
    ours = kron_core.kron_estimate_lin(_t(counts), POVM1, n, physical=physical)
    ref = np.asarray(jkron.kron_estimate_lin(counts, POVM1, n, physical=physical))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-8)
    dense = state_core.estimate_lin(_t(counts), _t(povm), _t(n_meas), physical=physical)
    np.testing.assert_allclose(ours.numpy(), dense.numpy(), atol=1e-8)


@pytest.mark.parametrize("n", [2, 3])
def test_rhor_matches_dense_and_jax(n):
    counts, povm, n_meas = _counts(n, 4, seed=5 + n)
    ours = kron_core.kron_estimate_mle_rhor(_t(counts), POVM1, n, max_iter=80, tol=0.0)
    ref = np.asarray(jkron.kron_estimate_mle_rhor(counts, POVM1, n, max_iter=80, tol=0.0))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-7)
    dense = state_core.estimate_mle_rhor(_t(counts), _t(povm), _t(n_meas), max_iter=80, tol=0.0)
    np.testing.assert_allclose(ours.numpy(), dense.numpy(), atol=1e-7)
    # the default stop at tol
    stopped = kron_core.kron_estimate_mle_rhor(_t(counts), POVM1, n)
    np.testing.assert_allclose(stopped.numpy(),
                               np.asarray(jkron.kron_estimate_mle_rhor(counts, POVM1, n)),
                               atol=1e-7)


@pytest.mark.parametrize("n", [2, 3])
def test_nll_tril_matches_jax(n):
    counts, _, _ = _counts(n, 3, seed=9)
    freq = counts.reshape(3, -1)
    freq = freq / freq.sum(-1, keepdims=True)
    rng = np.random.default_rng(n)
    g = rng.normal(size=(3, 2**n, 2**n)) + 1j * rng.normal(size=(3, 2**n, 2**n))
    rho = g @ np.swapaxes(g.conj(), -1, -2) + 0.1 * np.eye(2**n)
    rho = rho / np.trace(rho, axis1=1, axis2=2)[:, None, None]
    x = np.asarray(jchol.matrix_to_real_tril_vec(rho))
    ours = kron_core.kron_nll_tril(_t(x), POVM1, n, _t(freq), 3**n)
    ref = [float(jkron.kron_nll_tril(v, POVM1, n, f, 3**n)) for v, f in zip(x, freq)]
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-10)


@pytest.fixture
def kron_pair(kron_budget):
    """The same kron-mode experiment in both packages (GHZ(2), 800 shots)."""
    jtmg = qt.StateTomograph(qt.GHZ(2), key=21)
    jtmg.experiment(800, "proj-set")
    assert jtmg.povm_matrix is None and jtmg.povm_kron is not None
    arrays = interop.to_numpy(jtmg)
    assert arrays["povm_matrix"] is None
    tmg = interop.tomograph_from_arrays(**arrays, device="cpu", dtype=F64)
    assert tmg.kron_mode
    return jtmg, tmg


@pytest.mark.parametrize("method", ["lin", "mle", "mle-rhor", "mle-constr"])
def test_kron_point_estimate_matches_jax(kron_pair, method):
    jtmg, tmg = kron_pair
    ours = tmg.point_estimate(method)
    ref = jtmg.point_estimate(method)
    np.testing.assert_allclose(ours.bloch, ref.bloch, atol=1e-8 if method == "lin" else 1e-7)
    assert ours.is_density_matrix(verbose=False)


def test_kron_mle_constr_runs_rhor(kron_pair):
    _, tmg = kron_pair
    before = kernels.rhor_mle.launches
    np.testing.assert_array_equal(tmg.point_estimate("mle-constr").bloch,
                                  tmg.point_estimate("mle-rhor").bloch)
    assert kernels.rhor_mle.launches == before
    with pytest.raises(NotImplementedError):
        tmg.point_estimate("bogus-method")


def test_kron_batch_api_and_nll_match_jax(kron_pair):
    jtmg, tmg = kron_pair
    counts = tmg.simulate_batch(3)
    assert counts.shape == (3, 9, 4) and counts.dtype == F64
    np.testing.assert_allclose(counts.sum(-1).numpy(), 800.0)
    c = counts.numpy()
    np.testing.assert_allclose(tmg.estimate_batch(counts, "lin").numpy(),
                               np.asarray(jtmg.estimate_batch(c, "lin")), atol=1e-8)
    np.testing.assert_allclose(tmg.estimate_batch(counts, "mle", max_iter=40).numpy(),
                               np.asarray(jtmg.estimate_batch(c, "mle", max_iter=40)),
                               atol=1e-7)
    x = np.asarray(jchol.matrix_to_real_tril_vec(np.eye(4) / 4 + 0.05 * np.diag([1, 0, 0, -1])))
    np.testing.assert_allclose(float(tmg._nll(x)), float(jtmg._nll(x)), atol=1e-10)


def test_kron_warm_start_merges_counts(kron_budget):
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=5, dtype=F64)
    tmg.experiment(400, "proj-set")
    assert tmg.kron_mode and tmg.results.shape == (9, 4)
    first = tmg.results.copy()
    tmg.experiment(600, "proj-set", warm_start=True)
    assert tmg.kron_mode and tmg.results.shape == (9, 4)
    np.testing.assert_allclose(tmg.results.sum(-1), 1000.0)
    np.testing.assert_allclose(tmg.n_measurements, 1000.0)
    assert np.all(tmg.results >= first)
    with pytest.raises(NotImplementedError):
        tmg.experiment(600, "sic", warm_start=True)
    with pytest.raises(NotImplementedError):
        tmg.experiment(np.full(9, 600.0), "proj-set", warm_start=True)


def test_non_uniform_design_above_the_budget_stays_dense(kron_budget):
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=6, dtype=F64)
    tmg.experiment(np.arange(1, 10) * 100.0, "proj-set")
    assert not tmg.kron_mode and tmg.povm_matrix.shape == (9, 4, 16)
    np.testing.assert_allclose(tmg.results.sum(-1), np.arange(1, 10) * 100.0)
    assert tmg.point_estimate("mle-rhor").is_density_matrix(verbose=False)


def test_kron_bootstrap_interval(kron_pair):
    jtmg, tmg = kron_pair
    ours = qtt.BootstrapStateInterval(tmg, n_points=128, method="mle", max_iter=40, key=3)
    dist, _ = ours((0.5, 0.9))
    assert ours.distances.shape == (128,)
    assert np.all(np.isfinite(ours.distances)) and np.all(np.diff(ours.distances) >= 0)
    ref = qt.BootstrapStateInterval(jtmg, n_points=128, method="mle", max_iter=40, key=3)
    ref_dist, _ = ref(np.linspace(0, 1, 128))
    assert 0.75 <= np.median(ours.distances) / np.median(ref_dist) <= 1.25
    # chunks of 5 resamples draw in turn from one generator
    gen = torch.Generator().manual_seed(0)
    chunked = kron_core.kron_bootstrap_distances(
        gen, _t(ours.state.bloch), POVM1, 2, 800.0, 12, method="lin", chunk=5
    )
    assert chunked.shape == (12,) and bool(torch.isfinite(chunked).all())


def test_kron_bootstrap_estimates_and_distances_match_jax():
    """The bootstrap's estimate and distance stages on identical counts."""
    counts, _, _ = _counts(2, 16, seed=12, shots=500)
    bloch_ref = 0.9 * qt.GHZ(2).bloch
    bloch_ref[0] = 0.25
    for dst in ("hs", "trace", "if"):
        est = kron_core.kron_estimate_mle_rhor(_t(counts), POVM1, 2, max_iter=60)
        ref = jkron.kron_estimate_mle_rhor(counts, POVM1, 2, max_iter=60)
        np.testing.assert_allclose(
            bootstrap_core._distance_batch(dst, est, _t(bloch_ref), 2).numpy(),
            np.asarray(jboot._distance_batch(dst, ref, bloch_ref, 2)),
            atol=1e-7,
        )


def test_kron_bootstrap_rejects_non_uniform_results_and_custom_distances(kron_pair):
    _, tmg = kron_pair
    results = tmg.results.copy()
    results[0] *= 2
    tmg.results = results
    with pytest.raises(NotImplementedError, match="uniform"):
        qtt.BootstrapStateInterval(tmg, n_points=8, state=qtt.GHZ(2))()
    tmg.results = results / np.where(np.arange(9) == 0, 2, 1)[:, None]
    tmg.dst = lambda a, b: qtt.hs_dst(a, b)
    with pytest.raises(NotImplementedError, match="custom distance"):
        qtt.BootstrapStateInterval(tmg, n_points=8, state=qtt.GHZ(2))()


def test_dense_rhor_above_six_qubits_matches_jax():
    """n = 7 takes the loop through the factored transforms: 64 random
    design rows (16 POVMs of 4 rows), an explicit start, 3 iterations."""
    n, m, p = 7, 16, 4
    rng = np.random.default_rng(7)
    single = np.stack([r for pair in POVM1 for r in pair])  # the 6 proj-set rows
    rows = np.ones((m * p, 1))
    for _ in range(n):
        pick = single[rng.integers(0, 6, size=m * p)]
        rows = np.einsum("ra,rb->rab", rows, pick).reshape(m * p, -1)
    povm = rows.reshape(m, p, 4**n)
    truth = 0.9 * qt.GHZ(n).bloch
    truth[0] = 1 / 2**n
    probs = np.einsum("mod,d->mo", povm, truth) * 2**n
    probs = probs / probs.sum(-1, keepdims=True)
    counts = np.stack([[rng.multinomial(300, q) for q in probs] for _ in range(2)])
    counts = counts.astype(np.float64)
    n_meas = np.full(m, 300.0)
    init = np.stack([truth, truth])
    ours = state_core.estimate_mle_rhor(_t(counts), _t(povm), _t(n_meas), _t(init), max_iter=3)
    ref = np.asarray(jcore.estimate_mle_rhor(counts, povm, n_meas, init, max_iter=3))
    assert ours.shape == (2, 4**n)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-8)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch_shape", [(), (5,), (2, 3)])
def test_rhor_kernel_rule(device, dtype, batch_shape):
    """The fused kernel takes only float32 batches of starts (B, D) on the
    card; everything else runs the plain loop, which honours `tol`."""
    counts = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    for n in (1, 4, 6, 7):
        bloch0 = torch.empty(batch_shape + (4**n,), device="meta")
        expected = (device == "cuda" and dtype == torch.float32 and len(batch_shape) == 1
                    and n <= 6)
        assert state_core._use_rhor_kernel(counts, bloch0) == expected
