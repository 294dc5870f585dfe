"""Port parity for the Cholesky maps, the likelihood and the 'mle' estimator.

Inputs are drawn once with numpy and handed to both packages, in float64.
The maps and the likelihood are held to quantpy_tpu at 1e-12 and 1e-10,
its autograd gradient to jax.grad at 1e-8. The estimator is held by
likelihood, not by iterate: the port's batched L-BFGS and optax's differ in
their floating-point paths, so each resample's NLL must be no worse than
the JAX package's + 1e-9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.ops import cholesky as jchol  # noqa: E402
from quantpy_tpu.tomography import state_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config, interop  # noqa: E402
from quantpy_tpu_torch.ops import cholesky, lbfgs  # noqa: E402
from quantpy_tpu_torch.tomography import state_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401


@pytest.fixture
def float64():
    prev = config.rdtype()
    config.set_dtype(torch.float64)
    yield
    config.set_dtype(prev)


def _random_density(rng, d, batch):
    g = rng.normal(size=batch + (d, d)) + 1j * rng.normal(size=batch + (d, d))
    rho = g @ np.swapaxes(g.conj(), -1, -2) + 0.05 * np.eye(d)
    return rho / np.trace(rho, axis1=-2, axis2=-1)[..., None, None]


def _counts(n, batch, seed, shots=1000, state=None):
    """Multinomial counts of `state` (default GHZ(n)) drawn with numpy,
    (batch, m, p), with the proj-set design."""
    rng = np.random.default_rng(seed)
    povm = qt.generate_measurement_matrix("proj-set", n)
    bloch = qt.GHZ(n).bloch if state is None else state
    probs = np.clip(np.einsum("mod,d->mo", povm, bloch) * 2**n, 0, 1)
    probs = probs / probs.sum(-1, keepdims=True)
    counts = np.stack(
        [[rng.multinomial(shots, p) for p in probs] for _ in range(batch)]
    ).astype(np.float64)
    return counts, povm, np.full(povm.shape[0], float(shots))


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _nll(blochs, counts, povm, n_meas):
    """Per-resample NLL of bloch vectors, in numpy."""
    n = int(round(np.log2(povm.shape[-1]) / 2))
    a = np.asarray(jcore.weighted_povm_flat(povm, n_meas))
    freq = counts.reshape(counts.shape[0], -1)
    freq = freq / freq.sum(-1, keepdims=True)
    return -(freq * np.log(np.asarray(blochs) @ a.T * 2**n + 1e-10)).sum(-1)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_tril_maps_match_jax(d):
    rng = np.random.default_rng(d)
    rho = _random_density(rng, d, (5,))
    ours = cholesky.matrix_to_real_tril_vec(torch.as_tensor(rho))
    ref = np.asarray(jchol.matrix_to_real_tril_vec(rho))
    assert ours.shape == (5, cholesky.tril_param_dim(d))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-12)
    np.testing.assert_allclose(cholesky.np_matrix_to_real_tril_vec(rho), ref, atol=1e-12)
    back = cholesky.real_tril_vec_to_matrix(ours)
    np.testing.assert_allclose(back.numpy(), np.asarray(jchol.real_tril_vec_to_matrix(ref)),
                               atol=1e-12)
    np.testing.assert_allclose(back.numpy(), rho, atol=1e-12)
    np.testing.assert_allclose(cholesky.np_real_tril_vec_to_matrix(ref), rho, atol=1e-12)
    assert cholesky.matrix_dim_from_param(d * d) == d


def test_tril_dim_rejects_a_non_square_length():
    with pytest.raises(ValueError):
        cholesky.matrix_dim_from_param(15)


@pytest.mark.parametrize("n", [1, 2])
def test_nll_and_its_gradient_match_jax(float64, n):
    counts, povm, n_meas = _counts(n, 3, seed=10 + n)
    rng = np.random.default_rng(n)
    x = np.asarray(jchol.matrix_to_real_tril_vec(_random_density(rng, 2**n, (3,))))
    a = np.asarray(jcore.weighted_povm_flat(povm, n_meas))
    freq = counts.reshape(3, -1)
    freq = freq / freq.sum(-1, keepdims=True)
    bloch = np.asarray(state_core.make_feasible_bloch(_t(rng.normal(size=(3, 4**n))), n))

    np.testing.assert_allclose(
        state_core.nll_bloch(_t(bloch), _t(a), _t(freq), n).numpy(),
        [float(jcore.nll_bloch(b, a, f, n)) for b, f in zip(bloch, freq)],
        atol=1e-10,
    )
    xt = _t(x).requires_grad_(True)
    ours = state_core.nll_tril(xt, _t(a), _t(freq), n)
    (grad,) = torch.autograd.grad(ours.sum(), xt)
    ref = np.asarray(jax.vmap(lambda v, f: jcore.nll_tril(v, a, f, n))(x, freq))
    ref_grad = np.asarray(jax.vmap(jax.grad(lambda v, f: jcore.nll_tril(v, a, f, n)))(x, freq))
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-10)
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-8)


@pytest.fixture(scope="module")
def mle_batch():
    """One JAX Cholesky-LBFGS run: 2 qubits, a batch of 4."""
    counts, povm, n_meas = _counts(2, 4, seed=20, shots=500)
    ref = np.asarray(jcore.estimate(counts, povm, n_meas, method="mle"))
    return counts, povm, n_meas, ref


def test_mle_likelihood_no_worse_than_jax(float64, mle_batch):
    counts, povm, n_meas, ref = mle_batch
    ours = state_core.estimate(_t(counts), _t(povm), _t(n_meas), method="mle").numpy()
    assert ours.shape == (4, 16)
    assert np.all(_nll(ours, counts, povm, n_meas) <= _nll(ref, counts, povm, n_meas) + 1e-9)
    np.testing.assert_allclose(ours[:, 0], 0.25, atol=1e-12)
    for b in ours:
        assert qtt.Qobj(b).is_density_matrix(verbose=False)


def test_mle_constr_is_mle(float64, mle_batch):
    counts, povm, n_meas, _ = mle_batch
    args = (_t(counts), _t(povm), _t(n_meas))
    assert torch.equal(
        state_core.estimate(*args, method="mle-constr"), state_core.estimate(*args, method="mle")
    )


def test_mle_single_experiment_and_mixed_init(float64, mle_batch):
    counts, povm, n_meas, _ = mle_batch
    one = state_core.estimate(_t(counts[1]), _t(povm), _t(n_meas), method="mle")
    batch = state_core.estimate(_t(counts), _t(povm), _t(n_meas), method="mle")
    assert one.shape == (16,)
    assert abs(_nll(one[None].numpy(), counts[1:2], povm, n_meas)
               - _nll(batch[1:2].numpy(), counts[1:2], povm, n_meas))[0] <= 1e-9
    mixed = state_core.estimate(_t(counts), _t(povm), _t(n_meas), method="mle", init="mixed")
    assert np.all(_nll(mixed.numpy(), counts, povm, n_meas)
                  <= _nll(batch.numpy(), counts, povm, n_meas) + 1e-8)


def test_lbfgs_rows_stop_on_their_own(float64):
    """A row started at its optimum stays there while the others move, and
    every row ends where it ends when it runs alone."""
    counts, povm, n_meas = _counts(2, 3, seed=30, shots=400)
    a = state_core.weighted_povm_flat(_t(povm), _t(n_meas))
    freq = _t(counts).reshape(3, -1)
    freq = freq / freq.sum(-1, keepdim=True)
    init = state_core.estimate_lin(_t(counts), _t(povm), _t(n_meas))
    x0 = cholesky.matrix_to_real_tril_vec(
        qtt.ops.bloch_to_matrix(state_core._mixed_start(init, 4, 0.01), 2)
    )

    def fun(rows):
        return lambda v: state_core.nll_tril(v, a, freq[rows], 2)

    optimum = lbfgs.lbfgs_minimize(fun([0]), x0[:1], max_iter=300, tol=1e-12)
    start = torch.cat([optimum, x0[1:]])
    out = lbfgs.lbfgs_minimize(fun([0, 1, 2]), start, max_iter=60, tol=1e-9)
    assert float((out[0] - optimum[0]).abs().max()) <= 1e-9
    assert float((out[1:] - x0[1:]).abs().max()) > 1e-3
    for row in (1, 2):
        alone = lbfgs.lbfgs_minimize(fun([row]), x0[row : row + 1], max_iter=60, tol=1e-9)
        # the rows' products round differently alone and in the batch, and
        # the optimum's flat directions carry that into the parameters
        np.testing.assert_allclose(out[row].numpy(), alone[0].numpy(), atol=1e-8)
        assert abs(float(fun([row])(out[row : row + 1]) - fun([row])(alone))) <= 1e-12


def test_lbfgs_stops_at_max_iter():
    """One iteration: the first step is a gradient step, min(1, 1/|g|) long
    and then line-searched; the Armijo condition holds."""
    target = torch.tensor([[3.0, -1.0], [0.5, 2.0]], dtype=torch.float64)
    fun = lambda v: ((v - target) ** 2).sum(-1)  # noqa: E731
    x0 = torch.zeros_like(target)
    one = lbfgs.lbfgs_minimize(fun, x0, max_iter=1)
    assert torch.all(fun(one) < fun(x0))
    full = lbfgs.lbfgs_minimize(fun, x0, max_iter=50, tol=1e-10)
    np.testing.assert_allclose(full.numpy(), target.numpy(), atol=1e-9)
    assert torch.equal(lbfgs.lbfgs_minimize(fun, x0, max_iter=0), x0)


def test_mle_agrees_with_rhor():
    """Both optimizers find the same maximum of the likelihood, as
    tests/test_state_tomography.py asks of the JAX package."""
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=4, dtype=torch.float64)
    tmg.experiment(5000, "proj-set")
    b_chol = tmg.estimate_batch(tmg.results, "mle", max_iter=300, tol=1e-6)
    b_rhor = tmg.estimate_batch(tmg.results, "mle-rhor", max_iter=3000)
    assert float(qtt.hs_dst(qtt.Qobj(b_chol.numpy()), qtt.Qobj(b_rhor.numpy()))) < 5e-4


def test_point_estimate_mle_recovers_state():
    state = qtt.Qobj(np.array([0.5, 0.35, -0.2, 0.1]))
    tmg = qtt.StateTomograph(state, key=3, dtype=torch.float64)
    tmg.experiment(100_000, "proj-set")
    est = tmg.point_estimate("mle")
    assert float(qtt.hs_dst(est, state)) < 0.02
    assert est.is_density_matrix(verbose=False)
    assert np.array_equal(tmg.point_estimate("mle-constr").bloch, est.bloch)


def test_flat_results_and_nll_match_jax():
    jtmg = qt.StateTomograph(qt.GHZ(2), key=8)
    jtmg.experiment(700, "proj-set")
    tmg = interop.tomograph_from_arrays(**interop.to_numpy(jtmg), device="cpu",
                                        dtype=torch.float64)
    np.testing.assert_array_equal(tmg.flat_results, jtmg.flat_results)
    rng = np.random.default_rng(2)
    x = np.asarray(jchol.matrix_to_real_tril_vec(_random_density(rng, 4, (3,))))
    np.testing.assert_allclose(
        tmg._nll(x).numpy(), [float(jtmg._nll(v)) for v in x], atol=1e-10
    )
    np.testing.assert_allclose(float(tmg._nll(x[0])), float(jtmg._nll(x[0])), atol=1e-10)
