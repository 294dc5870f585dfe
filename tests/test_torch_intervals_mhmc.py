"""The port's MCMC intervals (MHMCStateInterval, MHMCProcessInterval,
HolderInterval('mhmc')), bayesian_mean_estimate and the calibration harness
against quantpy_tpu on the CPU, in float64.

A JAX experiment is carried over with `interop`, so both packages build
their chains from identical counts and estimates. Each interval's target
and drift are captured where the interval hands them to its sampler, and
held at 1e-8 (mode seeking and the curvature rescale off: their draws
differ between the packages). The chains draw different numbers in the two
packages, so end-to-end radii are held to a Monte Carlo tolerance: d50 and
d90 within 35% of the JAX package's on 1-qubit experiments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.channel import dephasing  # noqa: E402
from quantpy_tpu.tomography import bootstrap_core as jboot  # noqa: E402
from quantpy_tpu.tomography import interval as jinterval  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import interop, metrics  # noqa: E402
from quantpy_tpu_torch.parallel import make_mesh  # noqa: E402
from quantpy_tpu_torch.tomography import bootstrap_core, interval  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

F64 = torch.float64
MC_REL = 0.35


def _carry(jtmg):
    arrays = interop.to_numpy(jtmg)
    if hasattr(jtmg, "channel"):
        tmg = interop.process_tomograph_from_arrays(**arrays, device="cpu", dtype=F64)
        tmg.reconstructed_channel = qtt.Channel(qtt.Qobj(jtmg.reconstructed_channel.choi.bloch))
        return tmg
    tmg = interop.tomograph_from_arrays(**arrays, device="cpu", dtype=F64)
    tmg.reconstructed_state = qtt.Qobj(np.asarray(jtmg.reconstructed_state.bloch))
    return tmg


@pytest.fixture(scope="module")
def jax_state():
    tmg = qt.StateTomograph(qt.Qobj(np.array([0.5, 0.25, -0.2, 0.3])), key=31)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("lin")
    return tmg


@pytest.fixture(scope="module")
def jax_state_kron():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)
        tmg = qt.StateTomograph(qt.GHZ(2), key=33)
        tmg.experiment(3000, "proj-set")
        tmg.point_estimate("lin")
    assert tmg.povm_matrix is None
    return tmg


@pytest.fixture(scope="module")
def jax_process():
    tmg = qt.ProcessTomograph(dephasing(0.3), key=32)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("lifp")
    return tmg


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, iv):
    """The (target, kwargs) an interval hands to its sampler; the sampler
    itself never runs."""
    seen = {}

    def fake(target, **kwargs):
        seen.update(kwargs, target=target)
        raise _Captured

    monkeypatch.setattr(module, "MHMC", fake)
    with pytest.raises(_Captured):
        iv.setup()
    monkeypatch.undo()
    return seen


def _grad_port(f, x):
    xt = torch.as_tensor(x, dtype=F64).requires_grad_(True)
    (g,) = torch.autograd.grad(f(xt).sum(), xt)
    return g.numpy()


def _hold_targets(theirs, ours, rng, spread, drift=True):
    """The port's target (and its autograd drift) equal the JAX target (and
    jax.grad of it) at points around the start, one chain at a time and
    as a batch of chains."""
    x0 = np.asarray(theirs["x_init"], dtype=np.float64)
    np.testing.assert_allclose(np.asarray(ours["x_init"]), x0, atol=1e-8)
    xs = x0 + spread * rng.normal(size=(3,) + x0.shape)
    want = np.asarray(jax.jit(jax.vmap(theirs["target"]))(xs))
    got = ours["target"](torch.as_tensor(xs, dtype=F64)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-10)
    np.testing.assert_allclose(float(ours["target"](torch.as_tensor(xs[0], dtype=F64))),
                               want[0], atol=1e-8, rtol=1e-10)
    if drift:
        np.testing.assert_allclose(_grad_port(ours["target"], xs),
                                   np.asarray(jax.jit(jax.vmap(jax.grad(theirs["target"])))(xs)),
                                   atol=1e-8, rtol=1e-8)


def test_tril_samples_distance(jax_state):
    rng = np.random.default_rng(2)
    tril = rng.normal(size=(6, 4))
    ref = np.asarray(jax_state.reconstructed_state.bloch)
    for name in ("hs", "trace", "if"):
        np.testing.assert_allclose(
            bootstrap_core.tril_samples_distance(name, torch.as_tensor(tril, dtype=F64), ref,
                                                 1).numpy(),
            np.asarray(jboot.tril_samples_distance(name, tril, ref, 1)), atol=1e-10)


@pytest.mark.parametrize("kron, temper", [(False, True), (False, False), (True, True)])
def test_state_interval_target_matches(monkeypatch, jax_state, jax_state_kron, kron, temper):
    jtmg = jax_state_kron if kron else jax_state
    tmg = _carry(jtmg)
    assert tmg.kron_mode == kron
    theirs = _capture(monkeypatch, jinterval,
                      qt.MHMCStateInterval(jtmg, temper=temper, n_points=8))
    ours = _capture(monkeypatch, interval,
                    qtt.MHMCStateInterval(tmg, temper=temper, n_points=8))
    assert ours["update_rule"] is qtt.mhmc.normalized_update
    _hold_targets(theirs, ours, np.random.default_rng(3), 0.05)


@pytest.mark.parametrize(
    "options",
    [dict(parametrization="bloch"),
     dict(parametrization="kraus", anchored=True, precondition=True),
     dict(parametrization="kraus", anchored=False, precondition=True, proposal="mala"),
     dict(parametrization="bloch", projected=True, proposal="mala"),
     dict(parametrization="bloch", projected=True, precondition=False)],
    ids=["bloch", "kraus-anchored-whitened", "kraus-rel-mala",
         "projected-mala", "projected-rw-diagonal"],
)
def test_process_interval_target_matches(monkeypatch, jax_process, options):
    options = dict(options)
    projected = options.pop("projected", False)
    tmg = _carry(jax_process)
    kw = dict(options, n_points=8, mode_seek=0, curv_probes=0)
    got = {}
    for name, package, module, t in (("theirs", qt, jinterval, jax_process),
                                     ("ours", qtt, interval, tmg)):
        if projected:
            monkeypatch.setattr(package.MHMCProcessInterval, "PROJECTED_TARGET_QUBITS", 1)
        got[name] = _capture(monkeypatch, module, package.MHMCProcessInterval(t, **kw))
    theirs, ours = got["theirs"], got["ours"]
    rng = np.random.default_rng(4)
    spread = 1e-3 if options["parametrization"] == "kraus" else 0.01
    # the random-walk projected target reads the projection's criterion
    # every 10 iterations: its value is held to the Dykstra tolerance
    if projected and options.get("proposal") != "mala":
        x0 = np.asarray(theirs["x_init"])
        np.testing.assert_allclose(np.asarray(ours["x_init"]), x0, atol=1e-8)
        x = x0 + spread * rng.normal(size=x0.shape)
        np.testing.assert_allclose(float(ours["target"](torch.as_tensor(x, dtype=F64))),
                                   float(theirs["target"](x)), rtol=1e-6)
        gen = torch.Generator()
        gen.manual_seed(0)
        delta = ours["jump_distr"](gen, (4, x0.size), F64, torch.device("cpu"))
        assert np.all(np.isfinite(delta.numpy())) and delta.std() > 0
        return
    # the projected MALA target's gradient is that of
    # cptp_project_bloch_diff, held in tests/test_torch_process_mhmc.py
    _hold_targets(theirs, ours, rng, spread, drift=not projected)
    assert bool(ours["refresh_logp"]) == bool(theirs["refresh_logp"])
    if options["parametrization"] == "bloch" and not projected:
        # the projected proposal of both packages
        x0 = np.asarray(theirs["x_init"])
        delta = rng.normal(size=x0.shape)
        np.testing.assert_allclose(
            ours["update_rule"](x0, delta, 0.01).numpy(),
            np.asarray(theirs["update_rule"](x0, delta, 0.01)), atol=1e-6)


def test_state_interval_end_to_end(jax_state):
    levels = np.array([0.5, 0.9])
    kw = dict(n_points=600, burn_steps=300, step=0.05, n_chains=4, key=5)
    want, _ = qt.MHMCStateInterval(jax_state, **kw)(levels)
    iv = qtt.MHMCStateInterval(_carry(jax_state), **kw)
    got, _ = iv(levels)
    np.testing.assert_allclose(got, want, rtol=MC_REL)
    assert 0 < iv.acceptance_rate < 1 and np.isfinite(iv.r_hat) and iv.ess > 0


def test_process_kraus_interval_end_to_end(jax_process):
    """The port's kraus-MALA chain (mode seeking, curvature rescale,
    adaptation) against the JAX package's adapted 'bloch' chain on the same
    counts: the same posterior through two parametrizations (their
    cross-check in the JAX package's docs/benchmarks.md), within MC_REL.
    The JAX kraus chain's compiles take ~30 s on a CPU; its targets are
    held above at 1e-8."""
    levels = np.array([0.5, 0.9])
    want, _ = qt.MHMCProcessInterval(jax_process, n_points=600, burn_steps=200, step=0.01,
                                     n_chains=4, adapt_step=True, key=6)(levels)
    iv = qtt.MHMCProcessInterval(_carry(jax_process), n_points=120, burn_steps=150,
                                 parametrization="kraus", proposal="mala", adapt_step=True,
                                 n_chains=2, thinning=2, mode_seek=50, curv_probes=4,
                                 return_samples=True, key=6)
    dist, cl, rate, mats = iv.setup()
    got, _ = iv(levels)
    np.testing.assert_allclose(got, want, rtol=MC_REL)
    assert len(mats) == 120 and 0.3 < rate < 0.9
    for m in mats[::20]:
        assert qtt.Channel(qtt.Qobj(m)).is_cptp(atol=1e-8, verbose=False)


def test_process_bloch_interval_samples_are_cptp(jax_process):
    iv = qtt.MHMCProcessInterval(_carry(jax_process), n_points=40, burn_steps=40, step=0.005,
                                 return_samples=True, key=6)
    dist, _, rate, mats = iv.setup()
    assert np.all(np.isfinite(dist)) and np.all(np.diff(dist) >= 0) and 0 < rate <= 1
    assert qtt.Channel(qtt.Qobj(mats[-1])).is_cptp(atol=1e-3, verbose=False)


def test_wrong_mode_and_mesh_raise(jax_state, jax_process):
    state, process = _carry(jax_state), _carry(jax_process)
    for iv in (qtt.MHMCStateInterval(process), qtt.MHMCProcessInterval(state)):
        with pytest.raises(NotImplementedError):
            iv.setup()
    # the mesh path keeps the JAX package's rejections (more in
    # tests/test_torch_parallel.py)
    mesh = make_mesh(devices=["cpu"] * 2)
    asymmetric = dict(mesh=mesh, n_chains=2, n_points=4, burn_steps=2,
                      jump_logpdf=lambda d: -(d**2).sum(-1))
    for iv in (qtt.MHMCStateInterval(state, **asymmetric),
               qtt.MHMCProcessInterval(process, **asymmetric)):
        with pytest.raises(NotImplementedError, match="symmetric"):
            iv.setup()
    with pytest.raises(ValueError):
        qtt.MHMCProcessInterval(process, parametrization="choi")
    with pytest.raises(NotImplementedError, match="mala"):
        qtt.MHMCProcessInterval(process, proposal="mala").setup()


def test_holder_bayes_and_metrics(jax_process, jax_state):
    process = _carry(jax_process)
    iv = qtt.HolderInterval(process, n_points=60, kind="mhmc", burn_steps=60)
    dist, cl = iv(np.linspace(0.5, 0.95, 5))
    assert np.all(np.isfinite(dist)) and np.all(np.diff(dist) >= -1e-12)
    assert all(type(c) is qtt.MHMCStateInterval for c in iv.intervals)
    np.testing.assert_allclose(cl, np.linspace(0.5, 0.95, 5) ** 4)

    state = _carry(jax_state)
    rho, radius, diag = qtt.bayesian_mean_estimate(state, n_samples=150, n_chains=4,
                                                   burn_steps=150, key=3)
    assert rho.is_density_matrix(verbose=False) and 0 < radius < 0.5
    assert 0.05 < diag["acceptance_rate"] < 0.95 and diag["n_pooled_samples"] == 600
    assert float(qtt.hs_dst(rho, state.state)) < 0.15

    levels = metrics.get_CL_list_state(qtt.zero(1), interval="mhmc", n_iter=2,
                                       n_measurements=300, n_points=60, burn_steps=60)
    assert levels.shape == (2,) and np.all((levels >= 0) & (levels <= 1))
    levels = metrics.get_CL_list_channel(qtt.dephasing(0.3), interval="mhmc", n_iter=1,
                                         n_measurements=300, n_points=20, burn_steps=20,
                                         step=0.005)
    assert levels.shape == (1,) and 0 <= levels[0] <= 1


def test_nll_operands_follow_new_results(jax_state, jax_process):
    """The tomographs bind the NLL's device operands once, and a new
    `results` makes them anew: the NLL then equals a fresh tomograph's."""
    state, process = _carry(jax_state), _carry(jax_process)
    x = torch.as_tensor(np.array([0.6, 0.2, -0.1, 0.3]), dtype=F64)
    y = torch.as_tensor(jax_process.reconstructed_channel.choi.bloch, dtype=F64)
    before = (float(state._nll(x)), float(process._nll(y)))
    assert state._nll_operands()[0] is state._nll_operands()[0]
    assert process._nll_operands()[0] is process._nll_operands()[0]
    state.results = np.asarray(state.results)[:, ::-1].copy()
    process.results = np.asarray(process.results)[:, :, ::-1].copy()
    after = (float(state._nll(x)), float(process._nll(y)))
    assert before[0] != after[0] and before[1] != after[1]
    fresh = interop.tomograph_from_arrays(**interop.to_numpy(state), device="cpu", dtype=F64)
    fresh_process = interop.process_tomograph_from_arrays(**interop.to_numpy(process),
                                                          device="cpu", dtype=F64)
    np.testing.assert_allclose(after, (float(fresh._nll(x)), float(fresh_process._nll(y))),
                               rtol=1e-12)
