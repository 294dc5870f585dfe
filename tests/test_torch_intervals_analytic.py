"""The port's analytic confidence intervals (moment, moment-fidelity,
Sugiyama, polytope and Holder) against quantpy_tpu on the CPU, in float64.

A JAX experiment is carried over with `interop`, so both packages build
their intervals from identical counts. Tolerances: 1e-10 relative for the
moment and Sugiyama radii and the fidelity bands; 1e-7 for the polytope
bounds, whose PDHG iteration counts must be equal. Kron mode is forced at
2 qubits by lowering `StateTomograph.DENSE_POVM_MAX_ELEMENTS` in both
packages; the channel's stochastic moment path by lowering
`_CHANNEL_EXACT_GRAM_MAX`, where the Hutchinson variance is held to 5%.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.channel import dephasing, depolarizing  # noqa: E402
from quantpy_tpu.tomography import interval as jinterval  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import interop  # noqa: E402
from quantpy_tpu_torch.tomography import interval  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

F64 = torch.float64
LEVELS = np.linspace(0.1, 0.95, 12)


def _carry(jtmg):
    """The port's twin of a JAX tomograph of either kind, float64 on the
    CPU; a process twin keeps the single-qubit design factors."""
    arrays = interop.to_numpy(jtmg)
    if hasattr(jtmg, "channel"):
        tmg = interop.process_tomograph_from_arrays(**arrays, device="cpu", dtype=F64)
        tmg._states1_t, tmg._povm1 = jtmg._states1_t, jtmg._povm1
        return tmg
    return interop.tomograph_from_arrays(**arrays, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def jax_state():
    tmg = qt.StateTomograph(qt.GHZ(2), key=21)
    tmg.experiment(3000, "proj-set")
    return tmg


@pytest.fixture(scope="module")
def jax_state_kron():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)
        tmg = qt.StateTomograph(qt.GHZ(2), key=23)
        tmg.experiment(3000, "proj-set")
    assert tmg.povm_matrix is None and tmg.povm_kron is not None
    return tmg


@pytest.fixture(scope="module")
def jax_process():
    tmg = qt.ProcessTomograph(dephasing(0.3), key=22)
    tmg.experiment(3000, "proj-set")
    return tmg


@pytest.fixture(scope="module")
def jax_process_2q():
    tmg = qt.ProcessTomograph(depolarizing(0.3, 2), key=24)
    tmg.experiment(3000, "proj-set")
    return tmg


def _radii(cls, tmg, levels=LEVELS, **kw):
    dist, _ = cls(tmg, **kw)(levels)
    return np.asarray(dist, dtype=np.float64)


def _bands(cls, tmg, levels=LEVELS, **kw):
    iv = cls(tmg, **kw)
    (lo, hi), _ = iv(levels)
    return np.asarray(lo, dtype=np.float64), np.asarray(hi, dtype=np.float64), iv


# ------------------------------------------------------------------ moment


@pytest.mark.parametrize("distr_type", ["gamma", "norm", "exp"])
@pytest.mark.parametrize("dst", ["hs", "trace"])
def test_moment_interval_state_matches_jax(jax_state, distr_type, dst):
    ours_tmg, ref_tmg = _carry(jax_state), jax_state
    ours_tmg.dst = qtt.trace_dst if dst == "trace" else qtt.hs_dst
    jdst = qt.trace_dst if dst == "trace" else qt.hs_dst
    ref_tmg_dst, ref_tmg.dst = ref_tmg.dst, jdst
    try:
        ref = _radii(qt.MomentInterval, ref_tmg, distr_type=distr_type)
    finally:
        ref_tmg.dst = ref_tmg_dst
    ours = _radii(qtt.MomentInterval, ours_tmg, distr_type=distr_type)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)
    assert np.all(np.isfinite(ours)) and np.all(np.diff(ours) >= -1e-9)


def test_moment_interval_kron_matches_jax_and_dense(jax_state, jax_state_kron):
    ours = _radii(qtt.MomentInterval, _carry(jax_state_kron))
    np.testing.assert_allclose(ours, _radii(qt.MomentInterval, jax_state_kron), rtol=1e-10)
    # the same counts on the dense design give the same radii
    arrays = interop.to_numpy(jax_state_kron)
    dense = interop.tomograph_from_arrays(
        qt.generate_measurement_matrix("proj-set", 2), arrays["n_measurements"],
        arrays["results"], arrays["state_bloch"], device="cpu", dtype=F64)
    np.testing.assert_allclose(ours, _radii(qtt.MomentInterval, dense), rtol=1e-10)


@pytest.mark.parametrize("which", ["1q", "2q"])
def test_moment_interval_channel_matches_jax(jax_process, jax_process_2q, which):
    jtmg = jax_process if which == "1q" else jax_process_2q
    ours = _radii(qtt.MomentInterval, _carry(jtmg))
    np.testing.assert_allclose(ours, _radii(qt.MomentInterval, jtmg), rtol=1e-10)


def test_moment_interval_channel_stochastic_path(jax_process_2q, monkeypatch):
    tmg = _carry(jax_process_2q)
    exact = qtt.MomentInterval(tmg)
    exact.setup()
    monkeypatch.setattr(interval, "_CHANNEL_EXACT_GRAM_MAX", 1)
    stochastic = qtt.MomentInterval(tmg)
    stochastic.setup()
    assert stochastic.mean == pytest.approx(exact.mean, rel=1e-10)
    np.testing.assert_allclose(stochastic.variance, exact.variance, rtol=0.05)
    np.testing.assert_allclose(stochastic.cl_to_dist(LEVELS), exact.cl_to_dist(LEVELS),
                               rtol=0.05)
    tmg._povm1 = None
    with pytest.raises(NotImplementedError, match="tensor-power design"):
        qtt.MomentInterval(tmg)(LEVELS)


# -------------------------------------------------------------- fidelity bands


def test_moment_fidelity_state_matches_jax(jax_state):
    jtmg = qt.StateTomograph(qt.GHZ(2), key=21)
    jtmg.experiment(3000, "proj-set")
    ours = _bands(qtt.MomentFidelityStateInterval, _carry(jtmg),
                  target_state=qtt.GHZ(2))
    ref = _bands(qt.MomentFidelityStateInterval, jtmg, target_state=qt.GHZ(2))
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    assert np.all(ours[0] <= ours[1])
    # the default target is the unprojected linear-inversion estimate
    lo, hi, iv = _bands(qtt.MomentFidelityStateInterval, _carry(jax_state))
    np.testing.assert_allclose(iv.target_state.bloch,
                               jax_state.point_estimate(physical=False).bloch, atol=1e-12)
    assert np.all(lo <= hi)


def test_moment_fidelity_state_kron_matches_jax(jax_state_kron):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)
        ref = _bands(qt.MomentFidelityStateInterval, jax_state_kron, target_state=qt.GHZ(2))
    ours = _bands(qtt.MomentFidelityStateInterval, _carry(jax_state_kron),
                  target_state=qtt.GHZ(2))
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-10)


@pytest.mark.parametrize("which", ["1q", "2q"])
def test_moment_fidelity_process_matches_jax(jax_process, jax_process_2q, which):
    n = 1 if which == "1q" else 2
    jtmg = qt.ProcessTomograph(dephasing(0.3) if n == 1 else depolarizing(0.3, 2),
                               key=22 if n == 1 else 24)
    jtmg.experiment(3000, "proj-set")
    ours = _bands(qtt.MomentFidelityProcessInterval, _carry(jtmg))
    ref = _bands(qt.MomentFidelityProcessInterval, jtmg)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    assert np.all(ours[0] <= ours[1])


# ------------------------------------------------------------------ sugiyama


@pytest.mark.parametrize("dst", ["hs", "trace", "if"])
def test_sugiyama_interval_matches_jax(jax_state, dst):
    ours_tmg = _carry(jax_state)
    ours_tmg.dst = {"hs": qtt.hs_dst, "trace": qtt.trace_dst, "if": qtt.if_dst}[dst]
    saved = jax_state.dst
    jax_state.dst = {"hs": qt.hs_dst, "trace": qt.trace_dst, "if": qt.if_dst}[dst]
    try:
        ref = _radii(qt.SugiyamaInterval, jax_state)
    finally:
        jax_state.dst = saved
    np.testing.assert_allclose(_radii(qtt.SugiyamaInterval, ours_tmg), ref, rtol=1e-10)


def test_sugiyama_interval_kron_matches_jax(jax_state_kron):
    ours = _radii(qtt.SugiyamaInterval, _carry(jax_state_kron), n_points=300)
    ref = _radii(qt.SugiyamaInterval, jax_state_kron, n_points=300)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


# ------------------------------------------------------------------ polytopes


def _check_polytope(ours, ref):
    lo, hi, iv = ours
    rlo, rhi, riv = ref
    np.testing.assert_allclose(lo, rlo, atol=1e-7)
    np.testing.assert_allclose(hi, rhi, atol=1e-7)
    assert iv.lp_iterations == tuple(int(i) for i in riv.lp_iterations)
    assert max(iv.lp_iterations) <= iv.LP_ITERS
    assert np.all(lo <= hi + 1e-6)


def test_polytope_state_interval_matches_jax(jax_state):
    _check_polytope(_bands(qtt.PolytopeStateInterval, _carry(jax_state), n_points=20),
                    _bands(qt.PolytopeStateInterval, jax_state, n_points=20))


def test_polytope_state_interval_kron_matches_jax(jax_state_kron):
    _check_polytope(_bands(qtt.PolytopeStateInterval, _carry(jax_state_kron), n_points=20),
                    _bands(qt.PolytopeStateInterval, jax_state_kron, n_points=20))


@pytest.mark.parametrize("path", ["dense", "two-factor"])
def test_polytope_process_interval_matches_jax(jax_process, monkeypatch, path):
    if path == "two-factor":
        monkeypatch.setattr(interval._PolytopeBase, "DENSE_LP_MAX_ELEMENTS", 1)
        monkeypatch.setattr(jinterval._PolytopeBase, "DENSE_LP_MAX_ELEMENTS", 1)
    _check_polytope(_bands(qtt.PolytopeProcessInterval, _carry(jax_process), n_points=20),
                    _bands(qt.PolytopeProcessInterval, jax_process, n_points=20))


# ------------------------------------------------------------------ Holder


@pytest.mark.parametrize("kind", ["moment", "sugiyama"])
def test_holder_interval_matches_jax(jax_process, kind):
    ours = _radii(qtt.HolderInterval, _carry(jax_process), n_points=64, kind=kind)
    ref = _radii(qt.HolderInterval, jax_process, n_points=64, kind=kind)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_holder_moment_children_share_one_design_inverse(jax_process):
    iv = qtt.HolderInterval(_carry(jax_process), kind="moment")
    iv.setup()
    shared = iv.intervals[0]._design_inv
    assert isinstance(shared, torch.Tensor) and shared.dtype == F64
    assert all(child._design_inv is shared for child in iv.intervals)


@pytest.mark.parametrize("kind", ["bootstrap", "boot"])
def test_holder_bootstrap_interval(jax_process, kind):
    iv = qtt.HolderInterval(_carry(jax_process), n_points=64, kind=kind)
    dist, cl = iv(np.linspace(0.5, 0.95, 5))
    assert dist.shape == (5,) and np.all(np.isfinite(dist)) and np.all(dist >= 0)
    assert np.all(np.diff(dist) >= -1e-9)
    assert all(type(c) is qtt.BootstrapStateInterval for c in iv.intervals)
    np.testing.assert_allclose(cl, np.linspace(0.5, 0.95, 5) ** 4)


# ------------------------------------------------------------------ rejections


def test_intervals_reject_the_wrong_mode(jax_state, jax_process):
    state, process = _carry(jax_state), _carry(jax_process)
    for iv in (qtt.SugiyamaInterval(process), qtt.PolytopeStateInterval(process),
               qtt.HolderInterval(state)):
        with pytest.raises(NotImplementedError):
            iv.setup()
    with pytest.raises(ValueError):
        qtt.HolderInterval(process, kind="wang")()
    with pytest.raises(NotImplementedError, match="A14"):
        qtt.HolderInterval(process, kind="mhmc")()


def test_kron_intervals_reject_nonuniform_counts(jax_state_kron):
    tmg = _carry(jax_state_kron)
    results = np.asarray(tmg.results).copy()
    results[0] *= 3  # row sums now non-uniform
    tmg.results = results
    assert tmg.kron_mode
    for iv in (qtt.MomentInterval(tmg), qtt.SugiyamaInterval(tmg),
               qtt.PolytopeStateInterval(tmg, n_points=5)):
        with pytest.raises(NotImplementedError, match="uniform"):
            iv(np.array([0.5, 0.9]))


def test_moment_interval_rejects_other_distances_and_distributions(jax_state):
    tmg = _carry(jax_state)
    with pytest.raises(NotImplementedError):
        qtt.MomentInterval(tmg, distr_type="beta").setup()
    tmg.dst = qtt.if_dst
    with pytest.raises(NotImplementedError):
        qtt.MomentInterval(tmg).setup()
