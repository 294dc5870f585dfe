"""mhmc of the port against quantpy_tpu's on the CPU, in float64.

Deterministic functions (update rules, the scipy adapters' log-densities,
the diagnostics, Adam) are held at 1e-12 or 1e-8. The chains are held step
for step: JAX's own draws, rebuilt from its key schedule (one key per step,
split into the proposal's and the acceptance's), drive the port's step
functions, and the states and the accepted count must equal
`quantpy_tpu.mhmc._run_chain`'s at 1e-8. The port's own generator draws
other numbers, so the sampler class is held to statistics: the mean of a
Gaussian within 4 Monte Carlo standard errors.
"""

import numpy as np
import pytest
import scipy.stats as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu import mhmc as jmhmc  # noqa: E402

from quantpy_tpu_torch import interop, mhmc  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

F64 = torch.float64
FAMILIES = [st.norm(loc=0.1, scale=0.7), st.laplace(scale=2.0), st.cauchy(loc=-0.2),
            st.logistic(scale=0.5), st.t(df=3.5, scale=1.3), st.uniform(-0.4, 1.0)]


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def test_update_rules_and_scipy_log_densities():
    rng = np.random.default_rng(0)
    x, delta = rng.normal(size=(2, 5, 4))
    for ours, theirs in ((mhmc.basic_update, jmhmc.basic_update),
                         (mhmc.normalized_update, jmhmc.normalized_update)):
        np.testing.assert_allclose(ours(_t(x), _t(delta), 0.3).numpy(),
                                   np.asarray(theirs(x, delta, 0.3)), atol=1e-12)
    for frozen in FAMILIES:
        _, logq, sym = mhmc.from_scipy_frozen(frozen)
        _, jlogq, jsym = jmhmc.from_scipy_frozen(frozen)
        assert sym == jsym
        d = 0.3 * delta
        np.testing.assert_allclose(logq(_t(d)).numpy(), [float(jlogq(row)) for row in d],
                                   atol=1e-12)
        np.testing.assert_allclose(logq(_t(d)).numpy(), frozen.logpdf(d).sum(-1), atol=1e-12)
    with pytest.raises(NotImplementedError):
        mhmc.from_scipy_frozen(st.gamma(2.0))
    with pytest.raises(ValueError):
        mhmc.resolve_jump_distr("gumbel")


@pytest.mark.parametrize("frozen", FAMILIES, ids=lambda f: f.dist.name)
def test_scipy_samplers_follow_their_distribution(frozen):
    """The inverse-CDF (and Marsaglia-Tsang gamma) draws of the generator
    match the frozen distribution: Kolmogorov-Smirnov at 20,000 draws."""
    sampler, _, _ = mhmc.from_scipy_frozen(frozen)
    gen = torch.Generator()
    gen.manual_seed(3)
    draws = sampler(gen, (20000,), F64, torch.device("cpu")).numpy()
    assert st.kstest(draws, frozen.cdf).pvalue > 1e-3


def test_diagnostics():
    rng = np.random.default_rng(1)
    chains = np.cumsum(rng.normal(size=(4, 300)), axis=1) * 0.1 + rng.normal(size=(4, 300))
    for series in (chains, rng.normal(size=(3, 101)), chains[:, :3]):
        np.testing.assert_allclose(mhmc.split_rhat(series), jmhmc.split_rhat(series),
                                   rtol=1e-12, equal_nan=True)
        np.testing.assert_allclose(mhmc.effective_sample_size(series),
                                   jmhmc.effective_sample_size(series), rtol=1e-12)


@pytest.fixture(scope="module")
def one_qubit():
    jtmg = qt.StateTomograph(qt.Qobj(np.array([0.5, 0.3, 0.2, 0.1])), key=3)
    jtmg.experiment(400, "proj-set")
    port = interop.tomograph_from_arrays(**interop.to_numpy(jtmg), device="cpu", dtype=F64)
    return jtmg, port


def test_maximize_logpdf_matches_optax(one_qubit):
    jtmg, port = one_qubit
    x0 = np.array([0.6, 0.3, 0.1, -0.2])
    ours = mhmc.maximize_logpdf(lambda x: -port._nll(x), _t(x0), n_steps=200, lr=1e-2)
    theirs = jmhmc.maximize_logpdf(lambda x: -jtmg._nll(x), x0, n_steps=200, lr=1e-2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-8)
    assert float(port._nll(ours)) < float(port._nll(_t(x0)))


# -- step for step against quantpy_tpu.mhmc._run_chain --------------------------

_SCALE = np.array([1.0, 0.5, 2.0])


def _jlogpdf(x):
    return -0.5 * jnp.sum((x / _SCALE) ** 2) - 0.1 * jnp.sum(x**4) + 0.3 * x[0] * x[1]


def _logpdf(x):
    s = torch.as_tensor(_SCALE, dtype=x.dtype)
    return -0.5 * ((x / s) ** 2).sum(-1) - 0.1 * (x**4).sum(-1) + 0.3 * x[..., 0] * x[..., 1]


def _jax_draws(key, n_steps, shape, jump_fn):
    """The (delta, u) of every step of `_run_chain`, from its key schedule."""
    deltas, us = [], []
    for key_t in jax.random.split(key, n_steps):
        k1, k2 = jax.random.split(key_t)
        deltas.append(np.asarray(jump_fn(k1, shape, jnp.float64)))
        us.append(float(jax.random.uniform(k2, dtype=jnp.float64)))
    return np.stack(deltas), np.asarray(us)


@pytest.mark.parametrize("mode", ["mh", "hastings", "mala", "refresh"])
def test_chain_matches_jax_step_for_step(mode):
    n_steps, step = 50, 0.6
    x0 = np.array([0.3, -0.2, 0.5])
    key = jax.random.key(11)
    frozen = st.norm(loc=0.1)
    jump_fn = jmhmc._JUMP_DISTRS["normal"]
    jump_logpdf = drift = None
    port_jump_logpdf = None
    if mode == "hastings":
        jump_fn, jump_logpdf, _ = jmhmc.from_scipy_frozen(frozen)
        _, port_jump_logpdf, _ = mhmc.from_scipy_frozen(frozen)
    if mode == "mala":
        drift = jax.grad(_jlogpdf)
    # a noisy target for refresh_logp: exact here, so the same chain as MH
    # but with the current state's log-density evaluated every step
    xs, acc = jmhmc._run_chain(
        key, jnp.asarray(x0), _jlogpdf, jmhmc.basic_update, jump_fn, step, n_steps, 1,
        jump_logpdf=jump_logpdf, drift_fn=drift, refresh_logp=mode == "refresh",
    )
    deltas, us = _jax_draws(key, n_steps, x0.shape, jump_fn)
    x = _t(x0)
    accepted = 0
    if mode == "mala":
        drift_fn = mhmc.autograd_drift(_logpdf)
        logp, dx = mhmc._value_and_drift(_logpdf, drift_fn, x)
    else:
        logp = _logpdf(x)
    states = []
    for delta, u in zip(deltas, us):
        log_u = torch.log(_t(u))
        if mode == "mala":
            x, logp, dx, accept = mhmc.mala_step(x, logp, dx, _t(delta), log_u, _logpdf,
                                                 drift_fn, step)
        else:
            x, logp, accept = mhmc.mh_step(x, logp, _t(delta), log_u, _logpdf,
                                           mhmc.basic_update, step, port_jump_logpdf,
                                           refresh_logp=mode == "refresh")
        accepted += int(accept)
        states.append(x.numpy())
    np.testing.assert_allclose(np.stack(states), np.asarray(xs), atol=1e-8)
    assert accepted == int(acc)
    assert 5 < accepted < n_steps  # the test exercises both branches


def test_run_chain_thinning_and_nan_rejection():
    """Kept samples are the states at steps keep-1, 2 keep-1, ... of the
    same draws; a proposal whose target is NaN is rejected."""
    def run(keep):
        gen = torch.Generator()
        gen.manual_seed(4)
        return mhmc._run_chain(gen, _t(np.zeros((2, 3))), _logpdf, mhmc.basic_update,
                               mhmc.resolve_jump_distr(None), 0.5, 30, keep)

    every, acc1, last = run(1)
    thinned, acc3, _ = run(3)
    assert every.shape == (30, 2, 3) and thinned.shape == (10, 2, 3)
    np.testing.assert_array_equal(thinned.numpy(), every[2::3].numpy())
    assert int(acc1) == int(acc3) and torch.equal(last, every[-1])

    def nan_beyond(x):
        return torch.where(x[..., 0] > 0.2, torch.full_like(x[..., 0], float("nan")), _logpdf(x))

    gen = torch.Generator()
    gen.manual_seed(5)
    kept, _, _ = mhmc._run_chain(gen, _t(np.zeros((4, 3))), nan_beyond, mhmc.basic_update,
                                 mhmc.resolve_jump_distr(None), 0.5, 200, 1)
    assert float(kept[..., 0].max()) <= 0.2 and torch.isfinite(kept).all()


def test_sampler_statistics_on_a_gaussian():
    """Mean within 4 Monte Carlo standard errors (from the ESS), spread
    within 15%, for one chain and for chains side by side."""
    std = np.array([1.0, 2.0])

    def logpdf(x):
        return -0.5 * ((x / _t(std)) ** 2).sum(-1)

    chain = mhmc.MHMC(logpdf, step=1.0, burn_steps=500, dim=2, key=5, x_init=_t([0.5, 0.5]))
    samples, rate = chain.sample(4000, thinning=2)
    assert samples.shape == (4000, 2) and 0.1 < rate < 0.9
    multi = mhmc.MHMC(logpdf, step=1.5, burn_steps=200, dim=2, key=6, x_init=_t([0.5, 0.5]))
    chains, _ = multi.sample_chains(1000, n_chains=8)
    assert chains.shape == (8, 1000, 2)
    for s in (samples[None], chains):
        for i in range(2):
            ess = mhmc.effective_sample_size(s[..., i])
            assert abs(s[..., i].mean()) <= 4 * std[i] / np.sqrt(ess)
        np.testing.assert_allclose(s.reshape(-1, 2).std(0), std, rtol=0.15)


def test_adapt_step_lands_in_its_window():
    chain = mhmc.MHMC(lambda x: -0.5 * (x**2).sum(-1), step=50.0, burn_steps=0, dim=4,
                      key=8, x_init=_t(np.full(4, 0.5)))
    step = chain.adapt_step(segment=200, max_rounds=20, bounds=(0.2, 0.4), confirm=2)
    assert step < 50.0 and chain.burned
    _, rate = chain.sample(2000)
    assert 0.15 < rate < 0.45


def test_sampler_options():
    """Asymmetric proposals need their log-density; MALA needs the normal
    proposal; a frozen asymmetric proposal turns the correction on."""
    logpdf = lambda x: -0.5 * (x**2).sum(-1)  # noqa: E731
    # an array start (or none) takes the port's default dtype
    assert mhmc.MHMC(logpdf, dim=2).x_t.dtype == torch.float32
    with pytest.raises(ValueError):
        mhmc.MHMC(logpdf, symmetric=False, dim=2)
    with pytest.raises(ValueError):
        mhmc.MHMC(logpdf, jump_distr="laplace", drift_fn=mhmc.autograd_drift(logpdf), dim=2)
    chain = mhmc.MHMC(logpdf, jump_distr=st.norm(loc=0.3), step=1.0, burn_steps=300, dim=2,
                      key=1, x_init=_t([0.5, 0.5]))
    assert chain.jump_logpdf is not None
    samples, _ = chain.sample(4000)
    ess = mhmc.effective_sample_size(samples[None, :, 0])
    assert abs(samples[:, 0].mean()) <= 4 / np.sqrt(ess)  # corrected: no drift toward +loc
    sphere = mhmc.MHMC(lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype), step=0.3,
                       dim=4, update_rule=mhmc.normalized_update,
                       x_init=_t([1.0, 0, 0, 0]), key=7)
    np.testing.assert_allclose(np.linalg.norm(sphere.sample(100)[0], axis=1), 1.0, atol=1e-12)
