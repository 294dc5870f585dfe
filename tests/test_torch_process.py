"""ProcessTomograph and BootstrapProcessInterval of the port against
quantpy_tpu on the CPU, in float64.

A JAX process experiment is carried over with `interop`, so both packages
estimate from identical counts; the bootstrap's estimator is fed the JAX
package's resampled counts. Tolerances: 1e-8 for 'lifp', 1e-6 for the
iterative estimators and for the bootstrap distances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu import channel as jchannel  # noqa: E402
from quantpy_tpu.tomography import process_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import interop  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

F64 = torch.float64


@pytest.fixture(scope="module")
def jax_experiments():
    out = {}
    for n, shots in ((1, 2000), (2, 1000)):
        tmg = qt.ProcessTomograph(jchannel.depolarizing(0.15, n), key=20 + n)
        tmg.experiment(shots)
        out[n] = tmg
    return out


def _carry(jtmg, **kw):
    return interop.process_tomograph_from_arrays(
        **interop.to_numpy(jtmg), device="cpu", dtype=F64, **kw
    )


def test_interop_round_trip(jax_experiments):
    jtmg = jax_experiments[2]
    ours = _carry(jtmg)
    arrays, ref = interop.to_numpy(ours), interop.to_numpy(jtmg)
    assert set(arrays) == {"choi_bloch", "input_states", "povm_matrix", "n_measurements", "results"}
    for key in arrays:
        np.testing.assert_allclose(arrays[key], ref[key], atol=1e-12)
    assert arrays["results"].shape == (16, 9, 4)
    np.testing.assert_array_equal(ours.results, jtmg.results)
    np.testing.assert_allclose(ours._input_blochs_t(), jtmg._input_blochs_t(), atol=1e-12)
    np.testing.assert_allclose(
        ours._decomposed_single_entries, jtmg._decomposed_single_entries, atol=1e-8)
    assert all(t.device.type == "cpu" and t.dtype == F64 for t in ours.tomographs)
    assert all(t.generator is ours.generator for t in ours.tomographs)


@pytest.mark.parametrize("method, atol", [("lifp", 1e-8), ("states", 1e-6), ("dys", 1e-6),
                                          ("pgdb", 1e-6)])
@pytest.mark.parametrize("n", [1, 2])
def test_point_estimate_matches_jax(jax_experiments, n, method, atol):
    jtmg = jax_experiments[n]
    kwargs = dict(n_iter=15) if (method == "pgdb" and n == 2) else {}
    ours = _carry(jtmg).point_estimate(method, **kwargs)
    ref = jtmg.point_estimate(method, **kwargs)
    np.testing.assert_allclose(ours.choi.bloch, ref.choi.bloch, atol=atol)
    assert isinstance(ours, qtt.Channel) and ours.is_cptp(atol=1e-4, verbose=False)
    assert float(qtt.hs_dst(ours.choi, jtmg.channel.choi)) < 0.2


@pytest.mark.parametrize("states_est_method", ["mle-rhor", "mle"])
def test_states_method_with_mle_matches_jax(jax_experiments, states_est_method):
    jtmg = jax_experiments[1]
    kwargs = dict(states_est_method=states_est_method, n_iter=200)
    port = _carry(jtmg)
    ours = port.point_estimate("states", **kwargs)
    ref = jtmg.point_estimate("states", **kwargs)
    # 'mle' runs another optimizer than optax's: equal likelihood, not iterates
    atol = 1e-6 if states_est_method == "mle-rhor" else 2e-3
    np.testing.assert_allclose(ours.choi.bloch, ref.choi.bloch, atol=atol)
    assert hasattr(port.tomographs[0], "reconstructed_state")


def test_point_estimate_without_cptp_and_bad_method(jax_experiments):
    jtmg = jax_experiments[1]
    port = _carry(jtmg)
    raw = port.point_estimate("lifp", cptp=False)
    np.testing.assert_allclose(
        raw.choi.bloch, jtmg.point_estimate("lifp", cptp=False).choi.bloch, atol=1e-8)
    with pytest.raises(ValueError):
        port.point_estimate("nope")
    with pytest.raises(RuntimeError):
        qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), device="cpu").point_estimate()
    with pytest.raises(ValueError):
        qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), input_states=[qtt.zero(1)], device="cpu")


def test_big_n_dispatch_takes_the_ns_engine(jax_experiments, monkeypatch):
    """From BIG_N_QUBITS up 'lifp' and 'dys' project with the Newton-Schulz
    engine, criterion read per chunk; forced at 2 qubits in both packages."""
    jtmg = jax_experiments[2]
    port = _carry(jtmg)
    monkeypatch.setattr(qt.ProcessTomograph, "BIG_N_QUBITS", 2)
    monkeypatch.setattr(qtt.ProcessTomograph, "BIG_N_QUBITS", 2)
    ours, ref = port.point_estimate("lifp"), jtmg.point_estimate("lifp")
    np.testing.assert_allclose(ours.choi.bloch, ref.choi.bloch, atol=1e-8)
    monkeypatch.setattr(qtt.ProcessTomograph, "BIG_N_QUBITS", 5)
    exact = port.point_estimate("lifp")
    gap = np.abs(exact.choi.bloch - ours.choi.bloch).max()
    assert 0 < gap < 1e-4


def test_projections_and_nll_match_jax(jax_experiments):
    jtmg = jax_experiments[2]
    port = _carry(jtmg)
    rng = np.random.default_rng(3)
    off = qtt.Channel(qtt.Qobj(jtmg.channel.choi.bloch + 0.05 * rng.normal(size=256)))
    joff = qt.Channel(qt.Qobj(off.choi.bloch))
    for name in ("tp_projection", "cp_projection"):
        ours = getattr(port, name)(off, vectorized=True)
        np.testing.assert_allclose(ours, getattr(jtmg, name)(joff, vectorized=True), atol=1e-8)
        np.testing.assert_allclose(getattr(port, name)(off).choi.bloch, ours, atol=1e-12)
    ours = port.cptp_projection(off, n_iter=300)
    np.testing.assert_allclose(
        ours.choi.bloch, jtmg.cptp_projection(joff, n_iter=300).choi.bloch, atol=1e-8)
    assert ours.is_cptp(atol=1e-4, verbose=False)
    delta = rng.normal(size=(2, 256))
    for n_qubits, cp in ((2, "eigh"), (4, "ns")):
        # the update rule takes the 'ns' engine from 4 qubits up
        port.channel.n_qubits = jtmg.channel.n_qubits = n_qubits
        try:
            moved = port._cptp_update_rule(off.choi.bloch, delta, 0.01)
            ref = jtmg._cptp_update_rule(off.choi.bloch, delta, 0.01)
        finally:
            port.channel.n_qubits = jtmg.channel.n_qubits = 2
        np.testing.assert_allclose(moved.numpy(), np.asarray(ref), atol=1e-8)
    blochs = np.stack([jtmg.channel.choi.bloch, ours.choi.bloch])
    np.testing.assert_allclose(
        port._nll(blochs).numpy(), np.asarray(jtmg._nll(blochs)), rtol=1e-12)
    np.testing.assert_allclose(
        port._measurement_operator().numpy(), np.asarray(jtmg._measurement_operator()), atol=1e-8)
    assert port._cptp_tol(1e-30) == float(np.finfo(np.float64).eps) ** 1.5
    f32 = qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), device="cpu", dtype=torch.float32)
    assert f32._cptp_tol(1e-30) == float(np.finfo(np.float32).eps) ** 1.5


def test_experiment_counts_warm_start_and_results_setter():
    channel = qtt.depolarizing(0.2, 1)
    tmg = qtt.ProcessTomograph(channel, key=5, device="cpu", dtype=F64)
    assert tmg._states1_t.shape == (4, 4)
    tmg.experiment(300)
    assert tmg.results.shape == (4, 3, 2) and tmg._povm1.shape == (3, 2, 4)
    np.testing.assert_array_equal(tmg.results.sum(-1), 300.0)
    first = tmg.results.copy()
    tmg.experiment(700, warm_start=True)
    assert tmg.results.shape == (4, 6, 2) and tmg._povm1 is None
    np.testing.assert_array_equal(tmg.results[:, :3], first)
    np.testing.assert_array_equal(tmg.tomographs[0].n_measurements, [300.0] * 3 + [700.0] * 3)
    assert tmg.point_estimate("lifp").is_cptp(atol=1e-4, verbose=False)
    tmg.results = 2 * tmg.results
    np.testing.assert_array_equal(tmg.tomographs[1].n_measurements, [600.0] * 3 + [1400.0] * 3)
    tmg.experiment(np.array([100.0, 200.0, 300.0]), povm=qtt.generate_measurement_matrix("proj-set"))
    np.testing.assert_array_equal(tmg.results.sum(-1), np.tile([100.0, 200.0, 300.0], (4, 1)))
    assert tmg._povm1 is None


def test_simulated_experiment_follows_the_channel():
    """The counts' mean over many experiments against the probabilities of
    the channel's output states (distribution: the generators differ from
    the JAX package's)."""
    channel = qtt.amplitude_damping(0.3)
    tmg = qtt.ProcessTomograph(channel, key=8, device="cpu", dtype=F64)
    shots, reps = 500, 300
    total = np.zeros((4, 3, 2))
    for _ in range(reps):
        tmg.experiment(shots)
        total += tmg.results
    povm = qtt.generate_measurement_matrix("proj-set", 1)
    out = np.stack([channel.transform(s).bloch for s in tmg.input_basis.elements])
    probs = np.einsum("mod,sd->smo", povm, out) * 2
    sigma = np.sqrt(probs * (1 - probs) / (shots * reps))
    assert np.all(np.abs(total / (shots * reps) - probs) <= 5 * sigma + 1e-12)


def _jax_interval_with_counts(jtmg, monkeypatch, **kwargs):
    """Run the JAX interval and return (its sorted distances, the resampled
    counts it drew)."""
    drawn = {}
    simulate = jcore.simulate_process_experiment

    def recording(*args, **kw):
        drawn["counts"] = np.array(simulate(*args, **kw), dtype=np.float64)
        return drawn["counts"]

    monkeypatch.setattr(jcore, "simulate_process_experiment", recording)
    interval = qt.BootstrapProcessInterval(jtmg, key=jax.random.key(3), **kwargs)
    dist, _ = interval(np.linspace(0, 1, kwargs["n_points"]))
    return np.asarray(dist), drawn["counts"]


@pytest.mark.parametrize("n, kwargs", [
    (2, dict(method="lifp", cp_engine="eigh", cptp_iter=300)),
    (2, dict(method="lifp", cp_engine="ns")),
    (2, dict(method="lifp", cp_engine="ns", cptp_iter=7)),
    (2, dict(method="lifp", cptp=False)),
    (1, dict(method="lifp")),
    (1, dict(method="states")),
    (1, dict(method="states", states_est_method="mle-rhor", cptp=False)),
    (1, dict(method="dys")),
    (1, dict(method="pgdb")),
])
def test_bootstrap_distances_from_jax_counts(jax_experiments, monkeypatch, n, kwargs):
    jtmg = jax_experiments[n]
    center = jtmg.point_estimate("lifp")
    n_points = 6 if kwargs["method"] in ("dys", "pgdb") else 12
    ref, counts = _jax_interval_with_counts(
        jtmg, monkeypatch, n_points=n_points, channel=center, **kwargs)
    assert counts.shape == (n_points,) + jtmg.results.shape
    port = _carry(jtmg)
    interval = qtt.BootstrapProcessInterval(
        port, n_points=n_points, channel=qtt.Channel(qtt.Qobj(center.choi.bloch)), **kwargs)
    ours = np.sort(interval.distances_of(counts))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    assert np.all(ours > 0)


@pytest.mark.parametrize("dst", ["trace", "if"])
def test_bootstrap_named_distances_from_jax_counts(jax_experiments, monkeypatch, dst):
    jtmg = qt.ProcessTomograph(jchannel.depolarizing(0.15, 1), dst=dst, key=4)
    jtmg.experiment(1000)
    center = jtmg.point_estimate("lifp")
    ref, counts = _jax_interval_with_counts(jtmg, monkeypatch, n_points=8, channel=center)
    port = _carry(jtmg)
    port.dst = qtt.ops.resolve_distance(dst)
    interval = qtt.BootstrapProcessInterval(
        port, n_points=8, channel=qtt.Channel(qtt.Qobj(center.choi.bloch)))
    np.testing.assert_allclose(np.sort(interval.distances_of(counts)), ref, atol=1e-6)


def test_bootstrap_interval_end_to_end():
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=2, device="cpu", dtype=F64)
    tmg.experiment(10_000)
    interval = qtt.BootstrapProcessInterval(tmg, n_points=64, key=5)
    dist, levels = interval()
    assert dist.shape == levels.shape == (1000,)
    assert interval.distances.shape == (64,) and np.all(np.diff(interval.distances) >= 0)
    assert np.all(np.isfinite(interval.distances)) and interval.distances[0] > 0
    assert interval.channel is tmg.reconstructed_channel
    # a custom callable takes the host path; the same seed sees the same resamples
    custom_tmg = interop.process_tomograph_from_arrays(
        **interop.to_numpy(tmg), device="cpu", dtype=F64)
    custom_tmg.dst = lambda a, b: qtt.hs_dst(a, b)
    custom = qtt.BootstrapProcessInterval(
        custom_tmg, n_points=64, key=5, channel=interval.channel)
    custom()
    np.testing.assert_allclose(custom.distances, interval.distances, atol=1e-10)
    # the median lies near the estimate's own distance to the truth
    truth = float(qtt.hs_dst(interval.channel.choi, tmg.channel.choi))
    assert 0.5 * truth < np.median(interval.distances) < 2.0 * truth


def test_intervals_refuse_the_other_kind_of_tomograph():
    ptmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), device="cpu", dtype=F64)
    ptmg.experiment(100)
    with pytest.raises(NotImplementedError):
        qtt.BootstrapStateInterval(ptmg, n_points=4)()
    stmg = qtt.StateTomograph(qtt.GHZ(1), device="cpu", dtype=F64)
    stmg.experiment(100)
    with pytest.raises(NotImplementedError):
        qtt.BootstrapProcessInterval(stmg, n_points=4)()
    with pytest.raises(ValueError):
        qtt.BootstrapProcessInterval(ptmg, n_points=4, method="nope")()


def test_process_path_on_cpu_never_counts_a_launch():
    before = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), key=1, dtype=torch.float32)
    tmg.experiment(1000)
    assert tmg.device.type == "cpu" and tmg.results.dtype == np.float64
    est = tmg.point_estimate("states", states_est_method="mle-rhor")
    assert est.is_cptp(atol=1e-3, verbose=False)
    qtt.BootstrapProcessInterval(tmg, n_points=8)()
    assert (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches) == before
