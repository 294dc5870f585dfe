"""The ported main path as a whole, on the CPU, against quantpy_tpu.

A JAX experiment is carried over with `interop`, so both packages estimate
from identical counts; the port runs in float64 against JAX's x64 path.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.tomography import bootstrap_core as jboot  # noqa: E402
from quantpy_tpu.tomography import state_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config, interop  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.tomography import bootstrap_core, state_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

REPO = Path(__file__).resolve().parents[1]
ATOL64 = 1e-8


@pytest.fixture
def float64():
    prev = config.rdtype()
    config.set_dtype(torch.float64)
    yield
    config.set_dtype(prev)


@pytest.fixture(scope="module")
def jax_experiment():
    tmg = qt.StateTomograph(qt.GHZ(2), key=11)
    tmg.experiment(2000, "proj-set")
    return tmg


def _carry(jtmg, **kw):
    return interop.tomograph_from_arrays(
        jtmg.povm_matrix, jtmg.n_measurements, jtmg.results, jtmg.state.bloch,
        device="cpu", dtype=torch.float64, **kw,
    )


@pytest.mark.parametrize("method", ["lin", "mle-rhor"])
def test_point_estimate_matches_jax(jax_experiment, method):
    ours = _carry(jax_experiment).point_estimate(method)
    ref = jax_experiment.point_estimate(method)
    np.testing.assert_allclose(ours.bloch, ref.bloch, atol=ATOL64)
    assert ours.is_density_matrix(verbose=False)


def test_interop_round_trip(jax_experiment):
    arrays = interop.to_numpy(_carry(jax_experiment))
    np.testing.assert_array_equal(arrays["povm_matrix"], jax_experiment.povm_matrix)
    np.testing.assert_array_equal(arrays["n_measurements"], jax_experiment.n_measurements)
    np.testing.assert_array_equal(arrays["results"], jax_experiment.results)
    np.testing.assert_array_equal(arrays["state_bloch"], jax_experiment.state.bloch)


@pytest.mark.parametrize("dst, atol", [("hs", ATOL64), ("trace", ATOL64), ("if", ATOL64)])
def test_bootstrap_estimate_and_distance_match_jax(float64, dst, atol):
    """The bootstrap's estimate + distance stages on identical numpy counts."""
    rng = np.random.default_rng(12)
    povm = qt.generate_measurement_matrix("proj-set", 2)
    n_meas = np.full(9, 500.0)
    bloch_ref = qt.GHZ(2).bloch * 0.9
    bloch_ref[0] = 0.25  # a full-rank reference state
    probs = np.einsum("mod,d->mo", povm, bloch_ref) * 4
    counts = np.stack([[rng.multinomial(500, p / p.sum()) for p in probs] for _ in range(16)])
    counts = counts.astype(np.float64)

    est_ref = jcore.estimate(counts, povm, n_meas, method="mle-rhor", max_iter=80)
    d_ref = np.asarray(jboot._distance_batch(dst, est_ref, bloch_ref, 2))
    est = state_core.estimate(
        torch.as_tensor(counts), torch.as_tensor(povm), torch.as_tensor(n_meas),
        method="mle-rhor", max_iter=80,
    )
    np.testing.assert_allclose(est.numpy(), np.asarray(est_ref), atol=ATOL64)
    d = bootstrap_core._distance_batch(dst, est, torch.as_tensor(bloch_ref), 2)
    assert d.shape == (16,)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=atol)


def test_bootstrap_interval_median_close_to_jax(jax_experiment):
    """Different random streams on the same design: the medians agree within
    25% (fixed seeds, so the outcome is deterministic)."""
    port_tmg = _carry(jax_experiment)
    ours = qtt.BootstrapStateInterval(port_tmg, n_points=256, method="mle-rhor", key=3)
    ours()
    ref = qt.BootstrapStateInterval(jax_experiment, n_points=256, method="mle-rhor", key=3)
    ref_dist, _ = ref(np.linspace(0, 1, 256))
    dist = ours.distances
    assert dist.shape == (256,)
    assert np.all(np.isfinite(dist)) and np.all(np.diff(dist) >= 0)
    ratio = np.median(dist) / np.median(ref_dist)
    assert 0.75 <= ratio <= 1.25


def test_bootstrap_custom_distance_matches_named_distance(float64):
    """A custom callable takes the host path; with the same seed it sees the
    same resamples as the bloch-space 'hs' path."""
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=4)
    tmg.experiment(1000, "proj-set")
    named = qtt.BootstrapStateInterval(tmg, n_points=32, key=9)
    named()
    tmg_custom = interop.tomograph_from_arrays(
        **interop.to_numpy(tmg), device="cpu", dtype=torch.float64
    )
    tmg_custom.dst = lambda a, b: qtt.hs_dst(a, b)
    custom = qtt.BootstrapStateInterval(tmg_custom, n_points=32, key=9, state=named.state)
    custom()
    np.testing.assert_allclose(custom.distances, named.distances, atol=1e-12)


def test_tomograph_experiment_warm_start_and_results(float64):
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=1)
    tmg.experiment(400, "proj-set")
    first = tmg.results.copy()
    tmg.experiment(600, "proj-set", warm_start=True)
    assert tmg.results.shape == (18, 4)
    np.testing.assert_array_equal(tmg.results[:9], first)
    np.testing.assert_allclose(tmg.results.sum(-1), tmg.n_measurements)
    est = tmg.point_estimate("mle-rhor")
    assert est.is_density_matrix(verbose=False)
    batch = tmg.simulate_batch(3)
    assert batch.shape == (3, 18, 4)
    assert tmg.estimate_batch(batch, method="lin").shape == (3, 16)
    tmg.results = 2 * tmg.results
    np.testing.assert_allclose(tmg.n_measurements, [800.0] * 9 + [1200.0] * 9)


def test_port_never_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|quantpy_tpu)\b", re.MULTILINE)
    files = sorted((REPO / "quantpy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    files += sorted((REPO / "tools").glob("*.py"))
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_main_path_on_cpu_never_counts_a_launch():
    before = kernels.rhor_mle.launches
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=2)
    tmg.experiment(1000, "proj-set")
    qtt.BootstrapStateInterval(tmg, n_points=16, method="mle-rhor", key=1)()
    assert kernels.rhor_mle.launches == before
