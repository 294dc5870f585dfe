"""The port's moment statistics, sliced-ball bounds, batched PDHG linear
programs and polytope margins against quantpy_tpu on the CPU, in float64.

The inputs are drawn once with numpy and handed to both packages.
Tolerances: 1e-12 for the statistics, the ball bounds and the margin
bisection; 1e-8 for the LP solutions and objectives, whose iteration
counts must be equal (both packages stop on the same batch-maximum
residuals after the same 500-iteration chunks).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu import stats as jstats  # noqa: E402
from quantpy_tpu.convex import ball as jball  # noqa: E402
from quantpy_tpu.convex import lp as jlp  # noqa: E402
from quantpy_tpu.measurements import _single_qubit_preset  # noqa: E402
from quantpy_tpu.tomography.polytopes import utils as jutils  # noqa: E402

from quantpy_tpu_torch import convex, stats  # noqa: E402
from quantpy_tpu_torch.convex import lp  # noqa: E402
from quantpy_tpu_torch.tomography.polytopes import utils  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _freq(rng, m, p, shots=500):
    probs = rng.dirichlet(np.ones(p), size=m)
    return np.stack([rng.multinomial(shots, q) for q in probs]) / shots


@pytest.mark.parametrize("m, p", [(3, 2), (9, 4)])
def test_weight_tensor_moments_match_jax(m, p):
    rng = np.random.default_rng(m * p)
    f = _freq(rng, m, p)
    w = rng.normal(size=(m, p, m, p))
    w = np.einsum("aibj,ckbj->aick", w, w) / (m * p)
    for ours, ref in (
        (stats.l2_mean(f, 500), jstats.l2_mean(f, 500)),
        (stats.l2_variance(f, 500), jstats.l2_variance(f, 500)),
        (stats.l2_first_moment(f, 500, w), jstats.l2_first_moment(f, 500, w)),
        (stats.l2_second_moment(f, 500, w), jstats.l2_second_moment(f, 500, w)),
    ):
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
    np.testing.assert_array_equal(stats.make_identity_weights(f), jstats.make_identity_weights(f))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_factor_moments_match_jax_and_the_weight_form(as_tensor):
    rng = np.random.default_rng(5)
    v = rng.normal(size=(16, 9, 4))
    f = _freq(rng, 9, 4)
    ours = stats.l2_moments_from_factor(_t(v) if as_tensor else v, f, 700)
    np.testing.assert_allclose(ours, jstats.l2_moments_from_factor(v, f, 700), rtol=1e-12)
    w = np.einsum("dai,dbj->aibj", v, v)
    np.testing.assert_allclose(ours[0], stats.l2_first_moment(f, 700, w), rtol=1e-12)
    var_w = stats.l2_second_moment(f, 700, w) - stats.l2_first_moment(f, 700, w) ** 2
    np.testing.assert_allclose(ours[1], var_w, rtol=1e-9)


@pytest.mark.parametrize("radii", [np.linspace(0.0, 1.0, 7), np.array(0.3)])
def test_ball_slice_bounds_match_jax(radii):
    rng = np.random.default_rng(9)
    c, center = rng.normal(size=16), rng.normal(size=16) * 0.1
    fixed_idx, fixed_vals = np.array([0, 5]), np.array([0.25, 0.0])
    ours = convex.linear_bounds_on_ball_slice(c, center, radii, fixed_idx, fixed_vals)
    ref = jball.linear_bounds_on_ball_slice(c, center, radii, fixed_idx, fixed_vals)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
    assert np.isnan(ours[0]).any() == np.isnan(ref[0]).any()


def _polytope_lp(n, n_points, seed):
    """A state polytope LP of GHZ(n) with proj-set: (c, A, b (P, K))."""
    rng = np.random.default_rng(seed)
    povm = qt.generate_measurement_matrix("proj-set", n)
    m, dim = povm.shape[0], 2**n
    bloch = 0.9 * qt.GHZ(n).bloch
    bloch[0] = 1 / dim
    probs = np.einsum("mod,d->mo", povm, bloch) * dim
    freq = np.stack([rng.multinomial(1000, q / q.sum()) for q in probs]) / 1000
    povm_flat = povm.reshape(-1, povm.shape[-1])
    a = povm_flat[:, 1:] * dim
    deltas = np.linspace(0.02, 0.2, n_points)
    b = np.clip(freq.reshape(-1)[None] + deltas[:, None], 1e-15, 1 - 1e-15) - povm_flat[None, :, 0]
    return bloch[1:], a, b


def _check_lp(ours, ref, atol=1e-8):
    x, obj, viol, iters = ours
    np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), atol=atol)
    np.testing.assert_allclose(obj.numpy(), np.asarray(ref[1]), atol=atol)
    np.testing.assert_allclose(viol.numpy(), np.asarray(ref[2]), atol=atol)
    assert iters == int(ref[3])


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_dense_lp_matches_jax(sign):
    c, a, b = _polytope_lp(2, 6, seed=11)
    ours = lp.solve_lp_batch(sign * c, a, _t(b))
    _check_lp(ours, jlp.solve_lp_batch(sign * c, a, b))
    assert ours[0].shape == (6, 15) and ours[0].dtype == F64
    assert 0 < ours[3] <= 20000 and ours[3] % lp._CHUNK == 0


def test_dense_lp_iteration_cap_and_batched_objectives():
    c, a, b = _polytope_lp(1, 4, seed=12)
    cs = np.stack([c * s for s in (1.0, -1.0, 0.5, 2.0)])
    ours = lp.solve_lp_batch(cs, a, _t(b), n_iter=1000)
    _check_lp(ours, jlp.solve_lp_batch(cs, a, b, n_iter=1000))
    assert ours[3] <= 1000


def test_kron_lp_matches_jax_and_the_dense_lp():
    c, a, b = _polytope_lp(2, 5, seed=13)
    povm1 = _single_qubit_preset("proj-set")
    # the kron design's rows are those of the materialized proj-set design
    np.testing.assert_allclose(
        qt.generate_measurement_matrix("proj-set", 2).reshape(-1, 16)[:, 1:] * 4, a, atol=1e-14)
    ours = lp.solve_lp_batch_kron(c, povm1, 2, _t(b))
    _check_lp(ours, jlp.solve_lp_batch_kron(c, povm1, 2, b))
    dense = lp.solve_lp_batch(c, a, _t(b))
    np.testing.assert_allclose(ours[1].numpy(), dense[1].numpy(), atol=1e-6)


def test_two_factor_lp_matches_jax_and_the_dense_lp():
    rng = np.random.default_rng(14)
    left = rng.normal(size=(4, 3))
    right = rng.normal(size=(6, 2))
    x0 = rng.normal(size=(3, 2)) * 0.1
    a = np.einsum("sa,kb->skab", left, right).reshape(24, 6)
    b = (a @ x0.reshape(-1))[None] + np.linspace(0.05, 0.3, 4)[:, None]
    c = rng.normal(size=(3, 2))
    ours = lp.solve_lp_batch_factors(c, left, right, _t(b.reshape(4, 4, 6)), n_iter=5000)
    ref = jlp.solve_lp_batch_factors(c, left, right, b.reshape(4, 4, 6), n_iter=5000)
    _check_lp(ours, ref)
    assert ours[0].shape == (4, 3, 2)
    # the factored operator is the materialized kron(left, right)
    fwd = ours[0].reshape(4, 6).numpy() @ a.T
    assert np.all(fwd - b <= ours[2].numpy()[:, None] + 1e-12)


def test_lp_follows_the_dtype_of_b():
    c, a, b = _polytope_lp(1, 3, seed=15)
    x, obj, viol, iters = lp.solve_lp_batch(c, a, torch.as_tensor(b, dtype=torch.float32))
    assert x.dtype == obj.dtype == viol.dtype == torch.float32
    ref = lp.solve_lp_batch(c, a, _t(b))
    np.testing.assert_allclose(obj.numpy(), ref[1].numpy(), atol=5e-4)


@pytest.fixture(scope="module")
def frequencies():
    rng = np.random.default_rng(21)
    f2 = np.clip(_freq(rng, 9, 4, shots=3000), 1e-15, 1 - 1e-15)
    f3 = np.clip(np.stack([_freq(rng, 3, 2, shots=800) for _ in range(4)]), 1e-15, 1 - 1e-15)
    f2[0] = [1 - 1e-15, 1e-15, 1e-15, 1e-15]  # a certain outcome
    return {"state": (f2, np.full(9, 3000.0)), "process": (f3, np.full(3, 800.0))}


@pytest.mark.parametrize("kind", ["state", "process"])
def test_count_confidence_and_delta_match_jax(frequencies, kind):
    f, n = frequencies[kind]
    deltas = np.array([0.0, 1e-3, 0.01, 0.05, 0.2, 0.9])
    np.testing.assert_allclose(
        utils.count_confidence(_t(deltas), _t(f), _t(n)).numpy(),
        np.asarray(jutils.count_confidence(deltas, f, n)), rtol=1e-12, atol=1e-300)
    targets = np.array([0.0, 0.3, 0.9, 1 - 1e-7])
    ours = utils.count_delta(_t(targets), _t(f), _t(n)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jutils.count_delta(targets, f, n)), rtol=1e-12)
    scalar = utils.count_delta(0.9, _t(f), _t(n))
    assert scalar.shape == () and float(scalar) == pytest.approx(ours[2], rel=1e-15)
    assert np.all(np.diff(utils.count_confidence(_t(deltas), _t(f), _t(n)).numpy()) >= 0)
