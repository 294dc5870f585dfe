"""process_core of the port against quantpy_tpu's on the CPU, in float64.

One set of counts, drawn with numpy from a seed, goes through the JAX
function and its counterpart. Tolerances: 1e-8 for direct functions, 1e-10
for the Dykstra projections (the port's 'ns' engine steps on the matrices
throughout, the JAX package's in bloch space or per chunk), 1e-6 for the
iterative estimators.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.ops.cplx import to_pair  # noqa: E402
from quantpy_tpu.tomography import process_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch.ops.paulis import bloch_to_matrix, matrix_to_bloch  # noqa: E402
from quantpy_tpu_torch.tomography import process_core as core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

ATOL = 1e-8
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _design(n, shots=500.0, povm="proj-set"):
    """(input_blochs_t, povm_matrix, n_measurements) of the proj4 input
    basis, as numpy."""
    states = np.squeeze(qt.generate_measurement_matrix("proj4", n))
    states = states / (states[:, :1] * 2**n)
    signs = qtt.ops.pauli_transpose_signs(n)
    povm_matrix = qt.generate_measurement_matrix(povm, n)
    return states * signs, povm_matrix, np.full(povm_matrix.shape[0], shots)


def _experiment(n, batch=(), seed=0, shots=500, p_depol=0.2):
    """Counts batch + (S, m, p) of a depolarized random unitary channel."""
    rng = np.random.default_rng(seed)
    b, povm, n_meas = _design(n, float(shots))
    q, _ = np.linalg.qr(rng.normal(size=(2**n, 2**n)) + 1j * rng.normal(size=(2**n, 2**n)))
    channel = qtt.depolarize(qtt.Operator(q).as_channel(), p_depol)
    choi = channel.choi.bloch
    out = core.np_choi_apply_bloch(choi, b * qtt.ops.pauli_transpose_signs(n))
    probs = np.einsum("mod,sd->smo", povm, out) * 2**n
    probs = np.clip(probs, 0, None)
    probs /= probs.sum(-1, keepdims=True)
    counts = rng.multinomial(shots, probs, size=batch + probs.shape[:-1]).astype(np.float64)
    return counts, b, povm, n_meas, choi


def _rand_choi_blochs(n, batch, seed, spread=0.3):
    """Bloch vectors near a CPTP point, off both sets."""
    rng = np.random.default_rng(seed)
    center = qtt.depolarizing(0.5, n).choi.bloch
    return center + spread * rng.normal(size=batch + center.shape) / 4**n


@pytest.mark.parametrize("ns_iter", [2, 5, 19, 34])
def test_ns_schedule_tuples_equal(ns_iter):
    assert core._ns_schedule(ns_iter) == jcore._ns_schedule(ns_iter)
    assert len(core._ns_schedule(ns_iter)) == ns_iter


@pytest.mark.parametrize("n", [1, 2])
def test_tp_and_cp_projections_match_jax(n):
    x = _rand_choi_blochs(n, (3,), seed=n)
    tp = core.tp_project_bloch(_t(x))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jcore.tp_project_bloch(x)), atol=ATOL)
    c = tp.reshape(3, 4**n, 4**n)
    assert float((c[:, 1:, 0]).abs().max()) == 0.0 and float(c[0, 0, 0]) == 1 / 2**n
    cp = core.cp_project_bloch(_t(x))
    np.testing.assert_allclose(cp.numpy(), np.asarray(jcore.cp_project_bloch(x)), atol=ATOL)
    assert float(torch.linalg.eigvalsh(bloch_to_matrix(cp, 2 * n)).min()) > 0
    ns = core.cp_project_bloch_ns(_t(x))
    np.testing.assert_allclose(ns.numpy(), np.asarray(jcore.cp_project_bloch_ns(x)), atol=ATOL)
    norm = float(torch.linalg.matrix_norm(bloch_to_matrix(_t(x), 2 * n)).max())
    gap = float(torch.linalg.matrix_norm(bloch_to_matrix(ns - cp, 2 * n)).max())
    assert gap <= 1e-5 * norm
    ns5 = core.cp_project_bloch_ns(_t(x), ns_iter=5)
    np.testing.assert_allclose(ns5.numpy(), np.asarray(jcore.cp_project_bloch_ns(x, 5)), atol=ATOL)


@pytest.mark.parametrize("n", [1, 2])
def test_tp_project_mat_equals_the_bloch_form(n):
    x = _t(_rand_choi_blochs(n, (2, 3), seed=10 + n))
    via_mat = matrix_to_bloch(core._tp_project_mat(bloch_to_matrix(x, 2 * n)))
    np.testing.assert_allclose(via_mat.numpy(), core.tp_project_bloch(x).numpy(), atol=1e-12)
    ref = np.asarray(jcore._tp_project_mat(bloch_to_matrix(x, 2 * n).numpy()))
    np.testing.assert_allclose(core._tp_project_mat(bloch_to_matrix(x, 2 * n)).numpy(), ref, atol=ATOL)


def test_default_cptp_tol_follows_the_dtype():
    assert core.default_cptp_tol(None, torch.float32) == float(np.finfo(np.float32).eps) ** 1.5
    assert core.default_cptp_tol(1e-3, torch.float32) == 1e-3
    assert core.default_cptp_tol(1e-30, torch.float64) == float(np.finfo(np.float64).eps) ** 1.5
    assert core.default_cptp_tol(None, torch.float64) == jcore.default_cptp_tol()


@pytest.mark.parametrize("cp", ["eigh", "ns"])
@pytest.mark.parametrize("n", [1, 2])
def test_cptp_project_bloch_matches_jax(n, cp):
    x = _rand_choi_blochs(n, (4,), seed=20 + n)
    ours = core.cptp_project_bloch(_t(x), 300, 1e-14, cp)
    ref = np.asarray(jcore.cptp_project_bloch(x, 300, 1e-14, cp))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-10)
    ch = qtt.Channel(qtt.Qobj(ours[0].numpy()))
    assert ch.is_cptp(atol=1e-4, verbose=False)
    assert ours.dtype == F64 and ours.shape == x.shape


@pytest.mark.parametrize("chunk", [1, 7, 100])
@pytest.mark.parametrize("cp", ["eigh", "ns"])
@pytest.mark.parametrize("n", [1, 2])
def test_cptp_project_bloch_host_matches_jax(n, cp, chunk):
    x = _rand_choi_blochs(n, (4,), seed=30 + n)
    ours = core.cptp_project_bloch_host(_t(x), max_iter=250, tol=1e-12, chunk=chunk, cp=cp)
    ref = jcore.cptp_project_bloch_host(x, max_iter=250, tol=1e-12, chunk=chunk, cp=cp)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-10)


@pytest.mark.parametrize("cp", ["eigh", "ns"])
def test_host_projection_reads_the_criterion_once_per_chunk(monkeypatch, cp):
    """A run that converges in the middle of a chunk goes on to the chunk's
    end, as the JAX package's host loop does; chunk=1 stops at once."""
    steps = {"n": 0}
    name = "_dykstra_step_mat" if cp == "ns" else "_dykstra_step"
    step = getattr(core, name)

    def counted(*args, **kwargs):
        steps["n"] += 1
        return step(*args, **kwargs)

    monkeypatch.setattr(core, name, counted)
    x = _t(_rand_choi_blochs(1, (3,), seed=41))
    counts = {}
    for chunk in (1, 7):
        steps["n"] = 0
        core.cptp_project_bloch_host(x, max_iter=500, tol=1e-10, chunk=chunk, cp=cp)
        counts[chunk] = steps["n"]
    assert 0 < counts[1] < 500 and counts[1] % 7 != 0
    assert counts[7] == -(-counts[1] // 7) * 7
    steps["n"] = 0
    core.cptp_project_bloch_host(x, max_iter=10, tol=1e-10, chunk=7, cp=cp)
    assert steps["n"] == 10  # the cap cuts the last chunk
    steps["n"] = 0
    core.cptp_project_bloch(x, 500, 1e-10, cp)
    assert steps["n"] == counts[1]


@pytest.mark.parametrize("cp", ["eigh", "ns"])
def test_dykstra_chunk_matches_jax(cp):
    x = _rand_choi_blochs(2, (3,), seed=50)
    p = 0.01 * _rand_choi_blochs(2, (3,), seed=51)
    q = 0.01 * _rand_choi_blochs(2, (3,), seed=52)
    ours = core._dykstra_chunk(_t(x), _t(p), _t(q), 5, cp)
    ref = jcore._dykstra_chunk(x, p, q, 5, cp)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)


@pytest.mark.parametrize("n", [1, 2])
def test_measurement_model_matches_jax(n):
    counts, b, povm, n_meas, choi = _experiment(n, seed=60 + n)
    a = core.measurement_operator(_t(b), _t(povm), _t(n_meas))
    ja = jcore.measurement_operator(b, povm, n_meas)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)
    chois = np.stack([choi, qtt.depolarizing(0.3, n).choi.bloch])
    probs = core.process_probabilities(a, _t(chois))
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(jcore.process_probabilities(ja, chois)), atol=ATOL)
    s, k = b.shape[0], povm.shape[0] * povm.shape[1]
    # each POVM's weighted probabilities sum to its share of the shots
    np.testing.assert_allclose(probs.reshape(2, s, k).sum(-1).numpy(), 1.0, atol=ATOL)
    rng = np.random.default_rng(n)
    states = rng.normal(size=(5, 4**n))
    out = core.choi_apply_bloch(_t(choi), _t(states))
    np.testing.assert_allclose(out.numpy(), np.asarray(jcore.choi_apply_bloch(choi, states)), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), core.np_choi_apply_bloch(choi, states), atol=ATOL)
    np.testing.assert_allclose(
        core.np_choi_apply_bloch(choi, states), jcore.np_choi_apply_bloch(choi, states), atol=ATOL)
    batched = core.choi_apply_bloch(_t(chois), _t(states[:2]))
    np.testing.assert_allclose(
        batched.numpy(), np.asarray(jcore.choi_apply_bloch(chois, states[:2])), atol=ATOL)


@pytest.mark.parametrize("cptp", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_lifp_dense_factored_and_jax_agree(n, cptp):
    counts, b, povm, n_meas, _ = _experiment(n, batch=(3,), seed=70 + n)
    a = core.measurement_operator(_t(b), _t(povm), _t(n_meas))
    dense = core.estimate_lifp(_t(counts), a, cptp=cptp, cptp_iter=400)
    fact = core.estimate_lifp_factored(
        _t(counts), _t(b), _t(povm), _t(n_meas), cptp=cptp, cptp_iter=400)
    ref = jcore.estimate_lifp_factored(counts, b, povm, n_meas, cptp=cptp, cptp_iter=400)
    jdense = jcore.estimate_lifp(counts, np.asarray(a), cptp=cptp, cptp_iter=400)
    np.testing.assert_allclose(fact.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), fact.numpy(), atol=1e-7)
    single = core.estimate_lifp_factored(_t(counts[1]), _t(b), _t(povm), _t(n_meas), cptp=False)
    raw = core.estimate_lifp_factored(_t(counts), _t(b), _t(povm), _t(n_meas), cptp=False)
    np.testing.assert_allclose(single.numpy(), raw[1].numpy(), atol=1e-12)


def test_lifp_factored_three_qubits_matches_jax():
    counts, b, povm, n_meas, choi = _experiment(3, seed=73, shots=200)
    ours = core.estimate_lifp_factored(_t(counts), _t(b), _t(povm), _t(n_meas), cptp=False)
    ref = jcore.estimate_lifp_factored(counts, b, povm, n_meas, cptp=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    assert ours.shape == (4096,) and float((ours - _t(choi)).abs().max()) < 0.05


@pytest.mark.parametrize("n", [1, 2])
def test_process_nll_dense_factored_and_jax_agree(n):
    counts, b, povm, n_meas, choi = _experiment(n, seed=80 + n)
    chois = np.stack([choi, qtt.depolarizing(0.4, n).choi.bloch])
    flat = counts.reshape(-1)
    a = core.measurement_operator(_t(b), _t(povm), _t(n_meas))
    w = core.state_core.weighted_povm_flat(_t(povm), _t(n_meas))
    dense = core.process_nll(_t(chois), a, _t(flat))
    fact = core.process_nll_factored(_t(chois), _t(b), w, _t(flat))
    ref = jcore.process_nll_factored(chois, b, w.numpy(), flat)
    np.testing.assert_allclose(fact.numpy(), np.asarray(ref), rtol=1e-12)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jcore.process_nll(chois, a.numpy(), flat)),
                               rtol=1e-12)
    np.testing.assert_allclose(dense.numpy(), fact.numpy(), rtol=1e-10)
    assert float(fact[0]) < float(fact[1])


@pytest.mark.parametrize("n", [1, 2])
def test_states_to_choi_bloch_matches_jax(n):
    rng = np.random.default_rng(90 + n)
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), device="cpu", dtype=F64)
    dec = tmg._decomposed_single_entries
    out_blochs = rng.normal(size=(3, 4**n, 4**n)) / 2**n
    ours = core.states_to_choi_bloch(_t(out_blochs), dec)
    ref = jcore.states_to_choi_bloch(out_blochs, to_pair(dec))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    # exact output states give back the channel
    exact = np.stack([tmg.channel.transform(s).bloch for s in tmg.input_basis.elements])
    np.testing.assert_allclose(
        core.states_to_choi_bloch(_t(exact), dec).numpy(), tmg.channel.choi.bloch, atol=ATOL)


@pytest.mark.parametrize("n, kwargs", [(1, dict(max_iter=200, cptp_iter=300)),
                                        (2, dict(max_iter=12, cptp_iter=150))])
def test_pgdb_factored_matches_jax(n, kwargs):
    counts, b, povm, n_meas, _ = _experiment(n, batch=(2,), seed=100 + n)
    ours = core.estimate_pgdb_factored(_t(counts), _t(b), _t(povm), _t(n_meas), **kwargs)
    ref = jcore.estimate_pgdb_factored(counts, b, povm, n_meas, **kwargs)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_pgdb_init_bloch_and_step_match_the_jax_host_loop():
    counts, b, povm, n_meas, _ = _experiment(1, seed=110)
    init = np.array(jcore.estimate_lifp_factored(counts, b, povm, n_meas, cptp_iter=300))
    kwargs = dict(max_iter=25, cptp_iter=300, init_bloch=init)
    ours = core.estimate_pgdb_factored(_t(counts), _t(b), _t(povm), _t(n_meas), **kwargs)
    ref = jcore.estimate_pgdb_factored_host(counts, b, povm, n_meas, **kwargs)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    flat, tb, tw, x0 = core.pgdb_prepare(_t(counts), _t(b), _t(povm), _t(n_meas))
    jflat, jb, jw, jx0 = jcore.pgdb_prepare(counts, b, povm, n_meas)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=ATOL)
    x1, delta = core.pgdb_factored_step(x0, flat, tb, tw, 300)
    jx1, jdelta = jcore.pgdb_factored_step(jx0, jflat, jb, jw, 300)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=ATOL)
    assert abs(float(delta) - float(jdelta)) < ATOL


def test_pgdb_dense_matches_jax_and_the_factored_form():
    counts, b, povm, n_meas, _ = _experiment(1, batch=(2,), seed=120)
    a = core.measurement_operator(_t(b), _t(povm), _t(n_meas))
    kwargs = dict(max_iter=40, cptp_iter=300)
    dense = core.estimate_pgdb(_t(counts), a, **kwargs)
    ref = jcore.estimate_pgdb(counts, a.numpy(), **kwargs)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), atol=1e-6)
    fact = core.estimate_pgdb_factored(_t(counts), _t(b), _t(povm), _t(n_meas), **kwargs)
    np.testing.assert_allclose(dense.numpy(), fact.numpy(), atol=1e-6)


@pytest.mark.parametrize("n, cp, kwargs", [
    (1, None, dict(max_iter=3000, chunk=100)),
    (2, None, dict(max_iter=600, chunk=100)),
    (1, "ns", dict(max_iter=400, chunk=50)),
])
def test_dys_factored_matches_jax(n, cp, kwargs):
    counts, b, povm, n_meas, _ = _experiment(n, batch=(2,), seed=130 + n)
    init = np.array(jcore.estimate_lifp_factored(counts[0], b, povm, n_meas, cptp_iter=300))
    ours = core.estimate_dys_factored(
        _t(counts), _t(b), _t(povm), _t(n_meas), init_bloch=_t(init), cp=cp, **kwargs)
    ref = jcore.estimate_dys_factored(counts, b, povm, n_meas, init_bloch=init, cp=cp, **kwargs)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    flat, tb, tw, x0 = core.pgdb_prepare(_t(counts), _t(b), _t(povm), _t(n_meas))
    z, x_g, nll = core.dys_factored_chunk(x0, flat, tb, tw, 0.5 / 4**n, 3, cp or "eigh")
    jz, jx_g, jnll = jcore.dys_factored_chunk(
        np.asarray(x0), flat.numpy(), b, tw.numpy(), 0.5 / 4**n, 3, cp or "eigh")
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(x_g.numpy(), np.asarray(jx_g), atol=ATOL)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), atol=ATOL)


def test_dys_and_pgdb_reach_the_same_likelihood():
    counts, b, povm, n_meas, _ = _experiment(1, seed=140, shots=2000)
    design = (_t(counts), _t(b), _t(povm), _t(n_meas))
    dys = core.estimate_dys_factored(*design)
    pgdb = core.estimate_pgdb_factored(*design, cptp_iter=500)
    w = core.state_core.weighted_povm_flat(design[2], design[3])
    nll = core.process_nll_factored(torch.stack([dys, pgdb]), design[1], w, _t(counts.reshape(-1)))
    assert abs(float(nll[0] - nll[1])) <= 1e-6 * abs(float(nll[1]))


def test_simulated_counts_follow_the_probabilities():
    n, shots, reps = 1, 400, 2000
    _, b, povm, n_meas, choi = _experiment(n, seed=150, shots=shots)
    out = core.np_choi_apply_bloch(choi, b * qtt.ops.pauli_transpose_signs(n))
    gen = torch.Generator().manual_seed(5)
    blochs = _t(out).expand(reps, -1, -1)
    counts = core.simulate_process_experiment(gen, _t(povm), blochs, _t(n_meas))
    assert counts.shape == (reps, 4, 3, 2)
    assert bool((counts.sum(-1) == shots).all()) and bool((counts >= 0).all())
    assert bool((counts == counts.round()).all())
    probs = np.einsum("mod,sd->smo", povm, out) * 2**n
    mean = counts.mean(0).numpy() / shots
    sigma = np.sqrt(probs * (1 - probs) / (shots * reps))
    assert np.all(np.abs(mean - probs) <= 5 * sigma + 1e-12)
