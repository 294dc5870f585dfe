"""The port's binary-split multinomial sampler.

torch and jax.random streams never match bit for bit, so the sampler is
held to the multinomial distribution itself: exact totals, and the
per-outcome mean n p and variance n p (1 - p) within 5 standard errors on a
fixed seed (the run is deterministic).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quantpy_tpu_torch.ops.sampling import sample_multinomial  # noqa: E402
from quantpy_tpu_torch.tomography import state_core  # noqa: E402
import quantpy_tpu_torch as qtt  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_outcomes", [2, 6, 16])
def test_moments_match_multinomial(dtype, n_outcomes):
    rng = np.random.default_rng(n_outcomes)
    p = rng.dirichlet(np.ones(n_outcomes))
    n_trials, n_draws = 500.0, 20_000
    probs = torch.as_tensor(p, dtype=dtype)
    counts = sample_multinomial(_gen(1), n_trials, probs.expand(n_draws, -1)).double().numpy()
    assert counts.shape == (n_draws, n_outcomes)
    np.testing.assert_array_equal(counts.sum(-1), n_trials)
    mean_expected = n_trials * p
    var_expected = n_trials * p * (1 - p)
    se_mean = np.sqrt(var_expected / n_draws)
    assert np.all(np.abs(counts.mean(0) - mean_expected) <= 5 * se_mean)
    # standard error of a sample variance, from the binomial fourth moment
    mu4 = var_expected * (1 + 3 * (n_trials - 2) * p * (1 - p))
    se_var = np.sqrt((mu4 - var_expected**2) / n_draws)
    assert np.all(np.abs(counts.var(0, ddof=1) - var_expected) <= 5 * se_var)


def test_exact_totals_per_povm_and_zero_outcomes():
    n_shots = torch.tensor([1000.0, 250.0, 7.0], dtype=torch.float64)
    probs = torch.tensor(
        [[0.5, 0.5, 0.0], [0.2, 0.0, 0.8], [0.0, 1.0, 0.0]], dtype=torch.float64
    )
    counts = sample_multinomial(_gen(3), n_shots, probs.expand(64, 3, 3))
    assert counts.shape == (64, 3, 3)
    np.testing.assert_array_equal(counts.sum(-1).numpy(), np.broadcast_to(n_shots.numpy(), (64, 3)))
    assert torch.all(counts[..., 0, 2] == 0) and torch.all(counts[..., 1, 1] == 0)
    assert torch.all(counts[..., 2, 1] == 7)


def test_draws_reproducible_for_one_seed():
    probs = torch.full((81, 16), 1 / 16, dtype=torch.float32)
    probs = probs.expand(4, 81, 16)
    a = sample_multinomial(_gen(7), 10_000.0, probs)
    b = sample_multinomial(_gen(7), 10_000.0, probs)
    c = sample_multinomial(_gen(8), 10_000.0, probs)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_simulate_experiment_totals_follow_the_design():
    povm = torch.as_tensor(qtt.generate_measurement_matrix("proj-set", 2), dtype=torch.float64)
    bloch = qtt.GHZ(2).bloch_tensor(dtype=torch.float64)
    n_meas = torch.arange(1.0, 10.0, dtype=torch.float64) * 100
    counts = state_core.simulate_experiment(_gen(0), povm, bloch.expand(5, -1), n_meas)
    assert counts.shape == (5, 9, 4) and counts.dtype == torch.float64
    np.testing.assert_array_equal(counts.sum(-1).numpy(), np.broadcast_to(n_meas.numpy(), (5, 9)))
