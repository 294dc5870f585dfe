"""The port's mesh layer (`quantpy_tpu_torch.parallel`) on a mesh of CPU
shards against quantpy_tpu.parallel on the 8-device virtual mesh of
tests/conftest.py, in float64.

A `devices=["cpu"] * 8` mesh stands in for the JAX tests' 8 virtual
devices. The resample-sharded bootstraps and the coverage harness equal,
bit for bit, the single-device programs run shard by shard with the
documented per-shard generators (`mesh.shard_generators`); their medians
are held statistically against the JAX package's sharded functions, as in
tests/test_parallel.py. The operator-sharded kron functions equal the JAX
package's sharded ones and the port's single-device `kron_core` at 6
qubits. The chain intervals with `mesh=` agree with the local run within
the tolerances of tests/test_parallel.py.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu import parallel as jpar  # noqa: E402
from quantpy_tpu.measurements import _single_qubit_preset  # noqa: E402
from quantpy_tpu.tomography import kron_core as jkron  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config  # noqa: E402
from quantpy_tpu_torch.mhmc import _run_chain, normalized_update, resolve_jump_distr  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.ops.cholesky import np_matrix_to_real_tril_vec  # noqa: E402
from quantpy_tpu_torch.parallel import mesh as pm  # noqa: E402
from quantpy_tpu_torch.tomography import bootstrap_core, kron_core, state_core  # noqa: E402
from quantpy_tpu_torch.tomography.polytopes import verification  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

F64 = torch.float64
N6 = 6


@pytest.fixture(autouse=True)
def float64():
    prev = config.rdtype()
    config.set_dtype(F64)
    yield
    config.set_dtype(prev)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shards' many small operations slowed up to
    200-fold under the test workers' contention for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def design():
    """The GHZ-2 proj-set experiment of tests/test_parallel.py, as numpy."""
    tmg = qt.StateTomograph(qt.GHZ(2), key=11)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lin")
    return (np.asarray(est.bloch, np.float64), np.asarray(tmg.povm_matrix, np.float64),
            np.asarray(tmg.n_measurements, np.float64))


@pytest.fixture(scope="module")
def counts6():
    """Multinomial counts of GHZ-6 and the fully mixed state on the 6-qubit
    proj-set kron design, drawn with numpy."""
    rng = np.random.default_rng(2)
    povm1 = _single_qubit_preset("proj-set")
    bloch = np.stack([np.asarray(qt.GHZ(N6).bloch), np.asarray(qt.fully_mixed(N6).bloch)])
    probs = np.clip(np.asarray(jkron.kron_probs(povm1, N6, bloch)), 0, None)
    probs /= probs.sum(-1, keepdims=True)
    counts = np.stack([[rng.multinomial(1000, p) for p in row] for row in probs])
    return povm1, bloch, counts.astype(np.float64)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


# -- the mesh -----------------------------------------------------------------


def test_make_mesh():
    mesh = pm.make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.axis_names == ("batch",)
    assert mesh.distinct_devices == (torch.device("cpu"),)
    assert pm.make_mesh(3, devices=["cpu"] * 8).size == 3
    assert pm.make_mesh(axis_name="x", devices=["cpu"]).axis_names == ("x",)
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in pm.make_mesh().devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.make_mesh()


def test_exports_match_the_jax_package():
    import quantpy_tpu_torch.parallel as tpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    assert len(tpar.__all__) == 14 and all(hasattr(tpar, name) for name in tpar.__all__)


def test_shard_seeds_follow_the_documented_rule():
    want = [int(np.random.SeedSequence([7, i]).generate_state(1, np.uint64)[0])
            for i in range(3)]
    assert pm.shard_seeds(7, 3) == want
    gen = torch.Generator().manual_seed(3)
    first = pm.shard_seeds(gen, 4)
    assert len(set(first)) == 4 and pm.shard_seeds(gen, 4) != first  # one draw consumed
    assert pm.shard_seeds(torch.Generator().manual_seed(3), 4) == first


def test_run_shards_gives_each_device_a_thread():
    """Two distinct devices run at the same time (each first shard waits
    for the other at a barrier); a device's shards run in order in one
    thread; results come back in shard order."""
    mesh = pm.Mesh((torch.device("cpu", 0), torch.device("cpu", 1)) * 2)
    barrier = threading.Barrier(2, timeout=30)
    seen = {}

    def fn(i):
        if i < 2:
            barrier.wait()
        seen[i] = threading.get_ident()
        return i * i

    assert pm._run_shards(mesh, fn) == [0, 1, 4, 9]
    assert seen[0] == seen[2] and seen[1] == seen[3] and seen[0] != seen[1]


def test_launch_counts_survive_threads():
    """The wrappers count launches under a lock: shards on several devices
    launch from worker threads."""
    prev, interval = kernels.rhor_mle.launches, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.rhor_mle.launches = 0
        threads = [
            threading.Thread(target=lambda: [kernels._count_launch(kernels.rhor_mle)
                                             for _ in range(2000)])
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernels.rhor_mle.launches == 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        kernels.rhor_mle.launches = prev


# -- resample sharding ----------------------------------------------------------


@pytest.mark.parametrize("method", ["lin", "mle-rhor"])
def test_sharded_bootstrap(mesh8, design, method):
    bloch, povm, n_meas = design
    got = pm.sharded_bootstrap_distances(mesh8, 5, bloch, povm, n_meas, 64, method=method)
    assert got.shape == (64,) and got.dtype == F64
    want = torch.cat([
        bootstrap_core.bootstrap_distances(g, _t(bloch), _t(povm), _t(n_meas), 8, method=method)
        for g in pm.shard_generators(mesh8, 5)
    ])
    assert torch.equal(got, want)
    ref = np.asarray(jpar.sharded_bootstrap_distances(
        jpar.make_mesh(), jax.random.key(0), bloch, povm, n_meas, n_points=64, method=method))
    assert np.all(got.numpy() >= 0) and np.all(got.numpy() < 0.5)
    assert abs(float(got.median()) - np.median(ref)) < 0.05


@pytest.mark.parametrize("method,chunk", [("mle", None), ("lin", 3)])
def test_sharded_kron_bootstrap(mesh8, design, method, chunk):
    bloch, _, _ = design
    povm1 = _single_qubit_preset("proj-set")
    got = pm.sharded_kron_bootstrap_distances(
        mesh8, 3, bloch, povm1, 2, 1000.0, n_points=64, method=method, chunk=chunk)
    want = torch.cat([
        kron_core.kron_bootstrap_distances(g, _t(bloch), _t(povm1), 2, 1000.0, 8,
                                           method=method, chunk=chunk)
        for g in pm.shard_generators(mesh8, 3)
    ])
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    ref = np.asarray(jpar.sharded_kron_bootstrap_distances(
        jpar.make_mesh(), jax.random.key(3), bloch, povm1, 2, 1000.0, n_points=64,
        method=method, chunk=chunk))
    assert abs(float(got.median()) - np.median(ref)) < 0.05


def test_sharded_process_bootstrap(mesh8):
    """Statistics of the port's single-device BootstrapProcessInterval
    (tests/test_parallel.py's check)."""
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.4), key=13)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lifp")
    outs = np.stack([est.transform(s).bloch for s in tmg.input_basis.elements])
    t0 = tmg.tomographs[0]
    d = pm.sharded_process_bootstrap_distances(
        mesh8, 2, est.choi.bloch, outs, tmg._input_blochs_t(), t0.povm_matrix,
        t0.n_measurements, n_points=64).numpy()
    assert d.shape == (64,) and np.isfinite(d).all() and (d >= 0).all()
    iv = qtt.BootstrapProcessInterval(tmg, n_points=64, key=3)
    iv.setup()
    d_single = iv.cl_to_dist(np.linspace(0.05, 0.95, 10))
    assert abs(np.median(d) - np.median(d_single)) < 0.5 * np.median(d_single)


def test_sharded_coverage(mesh8):
    conf = np.array([0.5, 0.8, 0.95])
    problem = verification.qst_problem(qtt.GHZ(2), 500)
    cov = pm.sharded_coverage(mesh8, 4, problem, conf, n_trials=320)
    povm, n_meas, blochs, prod, offset, clip_b = problem
    hits = sum(
        verification.coverage_hits(g, povm, n_meas, _t(blochs), prod, offset, conf, 40, clip_b)
        for g in pm.shard_generators(mesh8, 4)
    )
    np.testing.assert_array_equal(cov, hits / 320)
    single = verification.test_qst(qtt.GHZ(2), conf, n_measurements=500, n_trials=320, key=5)
    np.testing.assert_allclose(cov, single, atol=0.12)
    assert np.all(cov >= conf - 0.1)
    conf2 = np.array([0.6, 0.9])
    cov2 = pm.sharded_coverage(
        mesh8, 6, verification.qpt_problem(qtt.depolarizing(0.3), 400), conf2, n_trials=160)
    assert cov2.shape == conf2.shape and np.all(cov2 >= conf2 - 0.15)


def _sizes_that_do_not_divide(design):
    bloch, povm, n_meas = design
    povm1 = _single_qubit_preset("proj-set")
    problem = verification.qst_problem(qtt.GHZ(1), 100)
    x0 = np.zeros(16)
    x0[0] = 1.0
    w = state_core.weighted_povm_flat(_t(povm), _t(n_meas)).numpy()
    return {
        "bootstrap": lambda m: pm.sharded_bootstrap_distances(m, 0, bloch, povm, n_meas, 63),
        "kron_bootstrap": lambda m: pm.sharded_kron_bootstrap_distances(
            m, 0, bloch, povm1, 2, 100.0, 63),
        "process_bootstrap": lambda m: pm.sharded_process_bootstrap_distances(
            m, 0, np.eye(16)[0] / 4, np.tile(np.eye(4)[0] / 2, (4, 1)), np.eye(4), povm,
            n_meas, 63),
        "coverage": lambda m: pm.sharded_coverage(m, 0, problem, [0.5], 63),
        "chains": lambda m: pm.sharded_mhmc_state_chains(
            m, 0, x0, w, np.full(w.shape[0], 1.0 / w.shape[0]), 2, 1.0, 0.01, 3, 4),
        "povm_rows": lambda m: pm.povm_sharded_probabilities(m, w[:-1], bloch),
    }


@pytest.mark.parametrize("what", ["bootstrap", "kron_bootstrap", "process_bootstrap",
                                  "coverage", "chains", "povm_rows"])
def test_sizes_that_do_not_divide_raise(mesh8, design, what):
    with pytest.raises(ValueError, match="must divide"):
        _sizes_that_do_not_divide(design)[what](mesh8)


# -- operator sharding at 6 qubits ----------------------------------------------


def test_operator_sharded_forward_adjoint_lin(mesh8, counts6):
    povm1, bloch, counts = counts6
    jmesh = jpar.make_mesh()
    fwd = pm.sharded_kron_forward_flat(mesh8, bloch, povm1, N6).numpy()
    np.testing.assert_allclose(fwd, kron_core.kron_forward_flat(_t(povm1), N6, _t(bloch)).numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        fwd, np.asarray(jpar.sharded_kron_forward_flat(jmesh, bloch, povm1, N6)), rtol=0, atol=1e-12)
    flat = counts.reshape(2, -1)
    adj = pm.sharded_kron_adjoint_flat(mesh8, flat, povm1, N6).numpy()
    np.testing.assert_allclose(adj, kron_core.kron_adjoint_flat(_t(povm1), N6, _t(flat)).numpy(),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        adj, np.asarray(jpar.sharded_kron_adjoint_flat(jmesh, flat, povm1, N6)), rtol=1e-12,
        atol=1e-15)
    lin = pm.sharded_kron_estimate_lin(mesh8, counts, povm1, N6).numpy()
    np.testing.assert_allclose(lin, kron_core.kron_estimate_lin(_t(counts), _t(povm1), N6).numpy(),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(
        lin, np.asarray(jpar.sharded_kron_estimate_lin(jmesh, counts, povm1, N6)), rtol=1e-10,
        atol=1e-13)
    with pytest.raises(ValueError, match="must divide by 3"):
        pm.sharded_kron_forward_flat(pm.make_mesh(devices=["cpu"] * 3), bloch, povm1, N6)


def test_operator_sharded_mle(mesh8, counts6):
    povm1, _, counts = counts6
    got = pm.sharded_kron_estimate_mle_rhor(mesh8, counts, povm1, N6, max_iter=40).numpy()
    single = kron_core.kron_estimate_mle_rhor(_t(counts), _t(povm1), N6, max_iter=40).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-8, atol=1e-10)
    ref = np.asarray(jpar.sharded_kron_estimate_mle_rhor(jpar.make_mesh(), counts, povm1, N6,
                                                         max_iter=40))
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match="must divide by 3"):
        pm.sharded_kron_estimate_mle_rhor(pm.make_mesh(devices=["cpu"] * 3), counts, povm1, N6)


def test_operator_sharded_mle_with_the_sandwich_whole():
    """A shard count that does not divide 2^n runs the R rho R sandwich
    whole on mesh.devices[0]: 3 shards of a 3-outcome design (the proj-set
    '+' outcome split in halves; p0 = 9 at 4 qubits)."""
    p = _single_qubit_preset("proj-set")
    povm3 = np.stack([p[:, 0] / 2, p[:, 0] / 2, p[:, 1]], axis=1)
    n = 4
    probs = kron_core.kron_probs(_t(povm3), n, _t(qt.GHZ(n).bloch)).numpy()
    rng = np.random.default_rng(4)
    counts = np.stack([rng.multinomial(500, q / q.sum()) for q in probs]).astype(np.float64)
    mesh3 = pm.make_mesh(devices=["cpu"] * 3)
    got = pm.sharded_kron_estimate_mle_rhor(mesh3, counts, povm3, n, max_iter=30).numpy()
    single = kron_core.kron_estimate_mle_rhor(_t(counts), _t(povm3), n, max_iter=30).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-8, atol=1e-10)


def test_povm_sharded_probabilities(mesh8, design):
    bloch, povm, n_meas = design
    w = state_core.weighted_povm_flat(_t(povm), _t(n_meas)).numpy()
    # pad rows to a multiple of 8 for even sharding, as tests/test_parallel.py does
    w = np.vstack([w, np.zeros(((-w.shape[0]) % 8, w.shape[1]))])
    got = pm.povm_sharded_probabilities(mesh8, w, bloch).numpy()
    np.testing.assert_allclose(got, w @ bloch, atol=1e-10)
    np.testing.assert_allclose(
        got, np.asarray(jpar.povm_sharded_probabilities(jpar.make_mesh(), w, bloch)), atol=1e-10)


def test_sharded_kron_simulate(mesh8, counts6):
    povm1, _, counts = counts6
    truth = np.asarray(qt.GHZ(N6).bloch)
    sim = pm.sharded_kron_simulate(mesh8, 6, povm1, truth, 1000.0)
    assert sim.shape == (3**N6, 2**N6) and len(sim.shards) == 8
    assert all(s.shape == (3**N6, 8) and s.device == d for s, d in zip(sim.shards, mesh8.devices))
    whole = sim.gather()
    assert whole.shape == (3**N6, 2**N6) and torch.equal(whole[:, 8:16], sim.shards[1])
    again = pm.sharded_kron_simulate(mesh8, 6, povm1, truth, 1000.0).gather()
    assert torch.equal(whole, again)
    # per-slice shot totals hold in expectation (the product-binomial design)
    assert abs(float(whole.sum()) / (1000.0 * 3**N6) - 1.0) < 0.01
    est = pm.sharded_kron_estimate_mle_rhor(mesh8, sim, povm1, N6, max_iter=40).numpy()
    single = kron_core.kron_estimate_mle_rhor(_t(counts[0]), _t(povm1), N6, max_iter=40).numpy()
    d_sh = float(np.linalg.norm(est - truth))
    d_ref = float(np.linalg.norm(single - truth))
    assert d_sh < 3 * max(d_ref, 1e-3), (d_sh, d_ref)


# -- the chains -----------------------------------------------------------------


def test_sharded_state_chains_equal_per_shard_runs(design):
    """Each shard's chains are `_run_chain` on its own generator: burn-in,
    then the kept span (every `thinning`-th state)."""
    bloch, povm, n_meas = design
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=11, dtype=F64)
    tmg.experiment(2000, "proj-set")
    freq, w = tmg._nll_operands()
    x0 = _t(np_matrix_to_real_tril_vec(np.eye(4) / 4))
    samples, rate = pm.sharded_mhmc_state_chains(
        mesh, 9, x0, w, freq, 2, 2000.0, 0.02, 4, 5, burn_steps=6, thinning=2)
    assert samples.shape == (4, 5, 16) and 0 < rate < 1

    def logpdf(x):
        return -2000.0 * state_core.nll_tril(x, w, freq, 2)

    parts, accepted = [], 0
    for g in pm.shard_generators(mesh, 9):
        x = x0.expand(2, 16).clone()
        _, a1, x = _run_chain(g, x, logpdf, normalized_update, resolve_jump_distr(None),
                              0.02, 6)
        kept, a2, _ = _run_chain(g, x, logpdf, normalized_update, resolve_jump_distr(None),
                                 0.02, 10, 2)
        parts.append(kept.transpose(0, 1))
        accepted += int(a1) + int(a2)
    np.testing.assert_array_equal(samples, torch.cat(parts).numpy())
    assert rate == accepted / (4 * 16)


@pytest.fixture(scope="module")
def state_tmg():
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=11, device="cpu", dtype=F64)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("lin")
    return tmg


def test_mesh_state_interval_matches_local(state_tmg):
    mesh = pm.make_mesh(devices=["cpu"] * 4)
    cl = np.linspace(0.1, 0.9, 5)
    kw = dict(n_points=640, burn_steps=400, n_chains=8, use_new_estimate=True, temper=False,
              adapt_step=True)
    d_local, _ = qtt.MHMCStateInterval(state_tmg, **kw)(cl)
    iv = qtt.MHMCStateInterval(state_tmg, **kw, mesh=mesh)
    d_mesh, _ = iv(cl)
    assert 0 < iv.acceptance_rate < 1
    rel = np.abs(np.asarray(d_mesh) - np.asarray(d_local)) / np.asarray(d_local)
    assert float(rel.max()) < 0.3


def test_mesh_state_interval_rejections(state_tmg, monkeypatch):
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    small = dict(n_points=8, burn_steps=2, use_new_estimate=True, mesh=mesh)
    with pytest.raises(ValueError, match="must divide"):
        qtt.MHMCStateInterval(state_tmg, n_chains=3, **small)(np.array([0.5]))
    with pytest.raises(NotImplementedError, match="symmetric"):
        qtt.MHMCStateInterval(state_tmg, n_chains=2, jump_logpdf=lambda d: -(d**2).sum(-1),
                              **small).setup()
    monkeypatch.setattr(qtt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)
    kron = qtt.StateTomograph(qtt.GHZ(2), key=3, device="cpu", dtype=F64)
    kron.experiment(1000, "proj-set")
    assert kron.povm_matrix is None
    with pytest.raises(NotImplementedError, match="dense design"):
        qtt.MHMCStateInterval(kron, n_chains=2, **small).setup()


def test_mesh_process_bloch_chains_match_local():
    tmg = qtt.ProcessTomograph(qtt.dephasing(0.3), key=22, device="cpu", dtype=F64)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("lifp")
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    cl = np.array([0.5])
    kw = dict(n_points=200, burn_steps=100, n_chains=8, adapt_step=True)
    d_local, _ = qtt.MHMCProcessInterval(tmg, **kw)(cl)
    iv = qtt.MHMCProcessInterval(tmg, **kw, mesh=mesh)
    d_mesh, _ = iv(cl)
    assert 0 < iv.acceptance_rate < 1
    assert abs(float(d_mesh[0]) - float(d_local[0])) < 0.5 * float(d_local[0])


@pytest.fixture(scope="module")
def depol_tmg():
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.2, 1), key=3, device="cpu", dtype=F64)
    tmg.experiment(1000, "proj-set")
    tmg.point_estimate("lifp")
    return tmg


def test_mesh_kraus_chains_match_local(depol_tmg):
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    kw = dict(n_points=160, burn_steps=100, step=0.05, parametrization="kraus",
              adapt_step=True, n_chains=8, mode_seek=100, curv_probes=8)
    iv = qtt.MHMCProcessInterval(depol_tmg, **kw, key=21, mesh=mesh)
    d, _ = iv(np.array([0.5]))
    assert np.isfinite(np.asarray(d)).all() and 0.0 < iv.acceptance_rate <= 1.0
    iv_v = qtt.MHMCProcessInterval(depol_tmg, **kw, key=22)
    iv_v(np.array([0.5]))
    levels = np.linspace(0.1, 0.9, 9)
    m, m_v = float(np.median(iv.cl_to_dist(levels))), float(np.median(iv_v.cl_to_dist(levels)))
    assert abs(m - m_v) < 0.7 * max(m, m_v), (m, m_v)


@pytest.mark.parametrize("case", ["mala", "not_anchored", "projected", "asymmetric"])
def test_mesh_process_rejections(depol_tmg, monkeypatch, case):
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    kw = dict(n_points=4, burn_steps=2, n_chains=2, mesh=mesh, mode_seek=0, curv_probes=0)
    if case == "mala":
        kw.update(parametrization="kraus", proposal="mala")
    elif case == "not_anchored":
        kw.update(parametrization="kraus", anchored=False)
    elif case == "projected":
        monkeypatch.setattr(qtt.MHMCProcessInterval, "PROJECTED_TARGET_QUBITS", 1)
    else:
        kw.update(jump_logpdf=lambda d: -(d**2).sum(-1))
    match = {"mala": "random-walk", "not_anchored": "anchored", "projected": "freezes",
             "asymmetric": "symmetric"}[case]
    with pytest.raises(NotImplementedError, match=match):
        qtt.MHMCProcessInterval(depol_tmg, **kw).setup()


def test_multichip_example_runs_on_the_cpu(capsys):
    from quantpy_tpu_torch.examples import multichip

    multichip.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: 8 shards, 8 shards on cpu" in out
    assert "born split in 8 shards of (729, 8)" in out
    gap = float(out.split("max|diff| ")[1].split()[0])
    assert gap < 1e-4  # float32: the sharded and single-device sums differ in order
