"""The RrhoR kernels, the PSD projection kernel and the eigenvalue clip kernel
on the card against their plain versions, and the paths without a kernel
(Cholesky MLE, kron chains, process tomography, the
analytic intervals' moments, linear programs and coverage harness, the MCMC
chains' targets, drifts and steps) on the card against the CPU; the console
entry points and the utilities on the card.

Marked `cuda`: these tests need an NVIDIA GPU with sm_90a (H100) and nvcc,
and skip elsewhere. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(the card's host has no `jax`, which tests/conftest.py imports).

Tolerances: 5e-5 in float32 (that of tests/test_kernels.py; sums run in
another order than cuBLAS's) and 1e-10 in float64.
"""

import pytest

torch = pytest.importorskip("torch")

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.tomography import state_core  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernel has no CPU mode")
    return torch.device("cuda")


def _problem(device, n, batch, dtype, seed, povm="proj-set"):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    povm = torch.as_tensor(qtt.generate_measurement_matrix(povm, n), dtype=dtype, device=device)
    n_meas = torch.full((povm.shape[0],), 2000.0, dtype=dtype, device=device)
    truth = qtt.GHZ(n).bloch_tensor(device, dtype)
    counts = state_core.simulate_experiment(gen, povm, truth.expand(batch, -1), n_meas)
    return counts, povm, n_meas


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "n, povm",
    [(1, "proj-set"), (2, "proj-set"), (3, "proj-set"), (4, "proj-set"), (5, "proj-set"),
     (6, "sic")],
)
def test_kernel_matches_plain(cuda, n, povm, dtype):
    counts, povm, n_meas = _problem(cuda, n, 11, dtype, seed=n, povm=povm)
    d = 2**n
    init = state_core.estimate_lin(counts, povm, n_meas)
    bloch0 = 0.95 * init
    bloch0[:, 0] += 0.05 / d
    freq = counts.reshape(11, -1)
    freq = (freq / freq.sum(-1, keepdim=True)).contiguous()
    w2 = (state_core.weighted_povm_flat(povm, n_meas) * d).contiguous()
    before = kernels.rhor_mle.launches
    out = kernels.rhor_mle(freq, bloch0.contiguous(), w2, n_iter=30)
    torch.cuda.synchronize()
    assert kernels.rhor_mle.launches == before + 1
    ref = kernels.rhor_mle_reference(freq, bloch0, w2, 30)
    assert float((out - ref).abs().max()) <= TOL[dtype]
    assert float((out[:, 0] - 1 / d).abs().max()) <= 1e-6


@pytest.mark.parametrize("batch, n_iter", [(1, 7), (9, 0)])
def test_kernel_single_resample_and_zero_iterations(cuda, batch, n_iter):
    counts, povm, n_meas = _problem(cuda, 2, batch, torch.float32, seed=3)
    freq = counts.reshape(batch, -1)
    freq = (freq / freq.sum(-1, keepdim=True)).contiguous()
    w2 = (state_core.weighted_povm_flat(povm, n_meas) * 4).contiguous()
    bloch0 = torch.zeros(batch, 16, device=cuda)
    bloch0[:, 0] = 0.25
    out = kernels.rhor_mle(freq, bloch0, w2, n_iter=n_iter)
    ref = kernels.rhor_mle_reference(freq, bloch0, w2, n_iter)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL[torch.float32]


def test_kernel_global_scratch_path(cuda):
    """n = 5 proj-set does not fit in shared memory: the scratch path."""
    counts, povm, n_meas = _problem(cuda, 5, 3, torch.float32, seed=5)
    freq = counts.reshape(3, -1)
    freq = (freq / freq.sum(-1, keepdim=True)).contiguous()
    w2 = (state_core.weighted_povm_flat(povm, n_meas) * 32).contiguous()
    init = state_core.estimate_lin(counts, povm, n_meas)
    bloch0 = (0.95 * init).contiguous()
    bloch0[:, 0] += 0.05 / 32
    out = kernels.rhor_mle(freq, bloch0, w2, n_iter=10)
    ref = kernels.rhor_mle_reference(freq, bloch0, w2, 10)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL[torch.float32]


def test_estimate_mle_rhor_goes_through_the_kernel(cuda):
    counts, povm, n_meas = _problem(cuda, 2, 5, torch.float32, seed=9)
    before = kernels.rhor_mle.launches
    flat_before = kernels.rhor_mle_flat.launches
    est = state_core.estimate(counts, povm, n_meas, method="mle-rhor", max_iter=40)
    torch.cuda.synchronize()
    assert kernels.rhor_mle.launches == before + 1
    assert kernels.rhor_mle_flat.launches == flat_before
    assert est.device.type == "cuda" and est.shape == (5, 16)
    assert bool(torch.isfinite(est).all())


def test_kernel_raises_instead_of_falling_back(cuda):
    freq = torch.full((2, 6), 1 / 6, device=cuda)
    bloch0 = torch.zeros(2, 4, device=cuda)
    w2 = torch.ones(6, 4, device=cuda)
    with pytest.raises(ValueError):
        kernels.rhor_mle(freq, bloch0, w2.cpu(), n_iter=2)


def _flat_inputs(device, n, batch, dtype, seed, povm="proj-set"):
    counts, povm, n_meas = _problem(device, n, batch, dtype, seed, povm=povm)
    d = 2**n
    init = state_core.estimate_lin(counts, povm, n_meas)
    bloch0 = 0.95 * init
    bloch0[:, 0] += 0.05 / d
    freq = counts.reshape(batch, -1)
    freq = (freq / freq.sum(-1, keepdim=True)).contiguous()
    w2 = (state_core.weighted_povm_flat(povm, n_meas) * d).contiguous()
    return freq, bloch0.contiguous(), w2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "n, povm",
    [(1, "proj-set"), (2, "proj-set"), (3, "proj-set"), (4, "proj-set"), (5, "proj-set"),
     (6, "sic")],
)
def test_flat_kernel_matches_plain(cuda, n, povm, dtype):
    freq, bloch0, w2 = _flat_inputs(cuda, n, 11, dtype, seed=20 + n, povm=povm)
    before = kernels.rhor_mle_flat.launches
    out = kernels.rhor_mle_flat(freq, bloch0, w2, n_iter=30)
    torch.cuda.synchronize()
    assert kernels.rhor_mle_flat.launches == before + 1
    ref = kernels.rhor_mle_flat_reference(freq, bloch0, w2, 30)
    assert float((out - ref).abs().max()) <= TOL[dtype]
    assert float((out[:, 0] - 1 / 2**n).abs().max()) <= 1e-6


@pytest.mark.parametrize("batch, n_iter", [(1, 7), (9, 0)])
def test_flat_kernel_single_resample_and_zero_iterations(cuda, batch, n_iter):
    freq, bloch0, w2 = _flat_inputs(cuda, 2, batch, torch.float32, seed=23)
    out = kernels.rhor_mle_flat(freq, bloch0, w2, n_iter=n_iter)
    ref = kernels.rhor_mle_flat_reference(freq, bloch0, w2, n_iter)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flat_kernel_global_scratch_path(cuda, dtype):
    """n = 5 proj-set does not fit in shared memory: the scratch path."""
    freq, bloch0, w2 = _flat_inputs(cuda, 5, 3, dtype, seed=25)
    out = kernels.rhor_mle_flat(freq, bloch0, w2, n_iter=10)
    ref = kernels.rhor_mle_flat_reference(freq, bloch0, w2, 10)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL[dtype]


def test_flat_kernel_raises_instead_of_falling_back(cuda):
    freq = torch.full((2, 6), 1 / 6, device=cuda)
    bloch0 = torch.zeros(2, 4, device=cuda)
    w2 = torch.ones(6, 4, device=cuda)
    before = kernels.rhor_mle_flat.launches
    with pytest.raises(ValueError):
        kernels.rhor_mle_flat(freq, bloch0, w2.cpu(), n_iter=2)
    assert kernels.rhor_mle_flat.launches == before


def _cpu_and_card(counts, povm, n_meas, dtype):
    """The same arrays as (CPU tensors, card tensors) in `dtype`."""
    cpu = tuple(x.to("cpu", dtype) for x in (counts, povm, n_meas))
    return cpu, tuple(x.to("cuda") for x in cpu)


def test_float64_rhor_runs_the_plain_loop(cuda):
    """A float64 batch runs the plain loop on the card, which stops at `tol`
    as the CPU path does; only float32 batches reach the kernel."""
    counts, povm, n_meas = _problem(cuda, 3, 5, torch.float64, seed=31)
    cpu, card = _cpu_and_card(counts, povm, n_meas, torch.float64)
    before = kernels.rhor_mle.launches
    on_card = state_core.estimate(*card, method="mle-rhor", max_iter=200, tol=1e-3)
    torch.cuda.synchronize()
    assert kernels.rhor_mle.launches == before
    on_cpu = state_core.estimate(*cpu, method="mle-rhor", max_iter=200, tol=1e-3)
    assert on_card.device.type == "cuda" and on_card.shape == (5, 64)
    assert float((on_card.cpu() - on_cpu).abs().max()) <= TOL[torch.float64]


def test_single_experiment_point_estimate_runs_the_plain_loop(cuda):
    """StateTomograph.point_estimate('mle-rhor') estimates one experiment:
    the plain loop on the card, equal to the CPU's on the same counts."""
    from quantpy_tpu_torch import interop

    tmg = qtt.StateTomograph(qtt.GHZ(3), key=7, device="cuda", dtype=torch.float32)
    tmg.experiment(2000, "proj-set")
    on_cpu = interop.tomograph_from_arrays(
        **interop.to_numpy(tmg), device="cpu", dtype=torch.float32
    )
    before = kernels.rhor_mle.launches
    est = tmg.point_estimate("mle-rhor")
    torch.cuda.synchronize()
    assert kernels.rhor_mle.launches == before
    assert abs(est.bloch - on_cpu.point_estimate("mle-rhor").bloch).max() <= TOL[torch.float32]


def test_kron_chains_on_the_card_match_the_cpu(cuda):
    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.tomography import kron_core

    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=torch.float64)
    gen = torch.Generator().manual_seed(4)
    for n in (4, 5):
        bloch = torch.randn(3, 4**n, generator=gen, dtype=torch.float64) / 4**n
        c = torch.rand(3, 3**n, 2**n, generator=gen, dtype=torch.float64)
        for fn, x in ((kron_core.kron_forward_flat, bloch), (kron_core.kron_apply_adjoint, c)):
            on_card = fn(povm1.to(cuda), n, x.to(cuda))
            assert float((on_card.cpu() - fn(povm1, n, x)).abs().max()) <= 1e-10
        counts = (c * 1000).round()
        on_card = kron_core.kron_estimate_mle_rhor(counts.to(cuda), povm1.to(cuda), n,
                                                   max_iter=20, tol=0.0)
        on_cpu = kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=20, tol=0.0)
        assert float((on_card.cpu() - on_cpu).abs().max()) <= 1e-10


def test_cholesky_mle_on_the_card_matches_the_cpu_likelihood(cuda):
    counts, povm, n_meas = _problem(cuda, 2, 8, torch.float64, seed=41)
    cpu, card = _cpu_and_card(counts, povm, n_meas, torch.float64)
    before = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    on_card = state_core.estimate(*card, method="mle")
    torch.cuda.synchronize()
    assert (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches) == before
    on_cpu = state_core.estimate(*cpu, method="mle")
    a = state_core.weighted_povm_flat(cpu[1], cpu[2])
    freq = cpu[0].reshape(8, -1)
    freq = freq / freq.sum(-1, keepdim=True)
    nll_card = state_core.nll_bloch(on_card.cpu(), a, freq, 2)
    nll_cpu = state_core.nll_bloch(on_cpu, a, freq, 2)
    assert float((nll_card - nll_cpu).abs().max()) <= 1e-9


def _process_design(n, batch, dtype, seed, shots=2000):
    """A process experiment's counts and design as CPU tensors: `batch`
    experiments on depolarizing(0.1, n), proj4 inputs, proj-set."""
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=seed, device="cpu", dtype=dtype)
    tmg.experiment(shots)
    _, b, povm, n_meas = tmg._design()
    out = torch.stack([
        torch.as_tensor(tmg.channel.transform(s).bloch, dtype=dtype)
        for s in tmg.input_basis.elements])
    gen = torch.Generator().manual_seed(seed)
    counts = state_core.simulate_experiment(gen, povm, out.expand(batch, -1, -1), n_meas)
    return counts, b, povm, n_meas


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_process_lifp_and_projections_on_the_card_match_the_cpu(cuda, dtype):
    from quantpy_tpu_torch.tomography import process_core

    cpu = _process_design(2, 6, dtype, seed=51)
    card = tuple(x.to(cuda) for x in cpu)
    raw_cpu = process_core.estimate_lifp_factored(*cpu, cptp=False)
    raw = process_core.estimate_lifp_factored(*card, cptp=False)
    assert raw.device.type == "cuda" and raw.dtype == dtype
    assert float((raw.cpu() - raw_cpu).abs().max()) <= TOL[dtype]
    for cp in ("eigh", "ns"):
        # a fixed count of iterations, so both devices run the same ones
        on_cpu = process_core.cptp_project_bloch_host(raw_cpu, max_iter=50, chunk=50, cp=cp)
        on_card = process_core.cptp_project_bloch_host(raw_cpu.to(cuda), max_iter=50, chunk=50, cp=cp)
        assert on_card.device.type == "cuda" and on_card.dtype == dtype
        assert float((on_card.cpu() - on_cpu).abs().max()) <= TOL[dtype]
    dec = qtt.ProcessTomograph(
        qtt.depolarizing(0.1, 2), device="cpu", dtype=dtype)._decomposed_single_entries
    outs = state_core.estimate_lin(cpu[0], cpu[2], cpu[3])
    choi_cpu = process_core.states_to_choi_bloch(outs, dec)
    choi = process_core.states_to_choi_bloch(outs.to(cuda), dec)
    assert float((choi.cpu() - choi_cpu).abs().max()) <= TOL[dtype]


def test_process_lifp_float32_close_to_float64_at_four_qubits(cuda):
    """The 256 x 256 Gram solves of the 4-qubit input basis in float32: the
    raw and the projected lifp estimates within 1e-3 in hs of float64's."""
    from quantpy_tpu_torch.tomography import bootstrap_core, process_core

    counts, b, povm, n_meas = _process_design(4, 2, torch.float64, seed=52)
    est = {}
    for dtype in (torch.float32, torch.float64):
        args = tuple(x.to(cuda, dtype) for x in (counts, b, povm, n_meas))
        raw = process_core.estimate_lifp_factored(*args, cptp=False)
        proj = process_core.cptp_project_bloch_host(raw, max_iter=50, chunk=50, cp="ns")
        assert raw.dtype == proj.dtype == dtype
        est[dtype] = (raw.double(), proj.double())
    for a, b64 in zip(est[torch.float32], est[torch.float64]):
        hs = bootstrap_core._distance_batch("hs", a, b64, 8)
        assert float(hs.max()) <= 1e-3


@pytest.mark.parametrize("states_est_method, expected", [("mle-rhor", 1), ("lin", 0)])
def test_process_states_method_launch_counts(cuda, states_est_method, expected):
    """'states' estimates the float32 batch (S, D) of output states in one
    call: one launch of the lane kernel for 'mle-rhor', none for 'lin'."""
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=53, dtype=torch.float32)
    tmg.experiment(10_000)
    before = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    est = tmg.point_estimate("states", states_est_method=states_est_method)
    torch.cuda.synchronize()
    assert kernels.rhor_mle.launches == before[0] + expected
    assert kernels.rhor_mle_flat.launches == before[1]
    assert est.is_cptp(atol=1e-3, verbose=False)


def test_process_tomograph_defaults_to_the_card(cuda):
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=54)
    assert tmg.device.type == "cuda" and tmg.generator.device.type == "cuda"
    tmg.experiment(10_000)
    assert all(t.device.type == "cuda" for t in tmg.tomographs)
    assert all(x.device.type == "cuda" for x in tmg._design())
    before = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    est = tmg.point_estimate("lifp")
    interval = qtt.BootstrapProcessInterval(tmg, n_points=64)
    counts = interval.simulate(torch.Generator(device="cuda").manual_seed(1))
    assert counts.device.type == "cuda" and counts.shape == (64, 16, 9, 4)
    assert interval.estimate(counts).device.type == "cuda"
    interval()
    assert interval.distances.shape == (64,)
    assert (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches) == before
    assert est.is_cptp(atol=1e-3, verbose=False)
    assert float(qtt.hs_dst(est.choi, tmg.channel.choi)) < 0.2


def _lp_problems(dtype):
    """(name, solver, args) of one small LP of each solver, CPU tensors."""
    import numpy as np

    from quantpy_tpu_torch.convex import lp
    from quantpy_tpu_torch.measurements import _single_qubit_preset

    rng = np.random.default_rng(61)
    povm = qtt.generate_measurement_matrix("proj-set", 2).reshape(-1, 16)
    a = povm[:, 1:] * 4
    x0 = qtt.GHZ(2).bloch[1:] * 0.9
    b = torch.as_tensor(a @ x0 + np.linspace(0.02, 0.2, 8)[:, None], dtype=dtype)
    left, right = rng.normal(size=(4, 3)), rng.normal(size=(6, 2))
    af = np.einsum("sa,kb->skab", left, right).reshape(24, 6)
    bf = torch.as_tensor(
        (af @ rng.normal(size=6) * 0.1 + np.linspace(0.05, 0.3, 4)[:, None]).reshape(4, 4, 6),
        dtype=dtype)
    return [
        ("dense", lp.solve_lp_batch, (x0, a, b)),
        ("kron", lp.solve_lp_batch_kron, (x0, _single_qubit_preset("proj-set"), 2, b)),
        ("factors", lp.solve_lp_batch_factors, (rng.normal(size=(3, 2)), left, right, bf)),
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_lps_on_the_card_match_the_cpu(cuda, which):
    """Each PDHG solver in float64: the same iterations and solutions as
    on the CPU."""
    name, solver, args = _lp_problems(torch.float64)[which]
    on_cpu = solver(*args)
    on_card = solver(*args[:-1], args[-1].to(cuda))
    assert on_card[0].device.type == cuda.type, name
    assert on_card[3] == on_cpu[3], name
    for a, b in zip(on_card[:3], on_cpu[:3]):
        assert float((a.cpu() - b).abs().max()) <= 1e-8, name


def test_count_delta_and_coverage_on_the_card_match_the_cpu(cuda):
    import numpy as np

    from quantpy_tpu_torch.tomography.polytopes import utils, verification

    problem = verification.qst_problem(qtt.GHZ(2), 500)
    freq = verification.simulate_frequencies(
        torch.Generator().manual_seed(62), *problem[:2],
        torch.as_tensor(problem[2], dtype=torch.float64), 200)
    targets = torch.tensor([0.0, 0.5, 0.9, 1 - 1e-7], dtype=torch.float64)
    on_cpu = utils.count_delta(targets, freq[0], problem[1])
    on_card = utils.count_delta(targets.to(cuda), freq[0].to(cuda), problem[1])
    assert on_card.device.type == cuda.type
    assert float((on_card.cpu() - on_cpu).abs().max()) <= 1e-12
    levels = np.linspace(0.05, 0.99, 18)
    hits_cpu = verification.coverage_of(freq, problem[1], *problem[3:5], levels, problem[5])
    hits = verification.coverage_of(freq.to(cuda), problem[1], *problem[3:5], levels, problem[5])
    np.testing.assert_array_equal(hits, hits_cpu)


def test_analytic_moments_on_the_card_match_the_cpu(cuda):
    """The channel's per-state Grams, the kron moments and the Hutchinson
    folds (fed one set of probes), all float64, on both devices."""
    import numpy as np

    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.tomography import kron_analytic

    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.3, 2), key=63, device="cpu",
                               dtype=torch.float64)
    tmg.experiment(3000)
    freq = np.stack([t.results / t.n_measurements[:, None] for t in tmg.tomographs])
    args = (tmg._input_blochs_t(), tmg.tomographs[0].povm_matrix, freq, 3000.0)
    povm1 = _single_qubit_preset("proj-set")
    probes = torch.randint(0, 2, (32, 4, 4), generator=torch.Generator().manual_seed(6))
    probes = probes.double() * 2 - 1
    for fn, fargs in (
        (kron_analytic.channel_l2_moments, args),
        (kron_analytic.kron_l2_moments, (povm1, 2, freq[3], 3000.0)),
        (kron_analytic.channel_l2_moments_kron, (tmg._states1_t, povm1, 2, freq, 3000.0)),
    ):
        kw = {"probes": probes} if fn is kron_analytic.channel_l2_moments_kron else {}
        on_cpu = fn(*fargs, device="cpu", **kw)
        on_card = fn(*fargs, device=cuda, **{k: v.to(cuda) for k, v in kw.items()})
        np.testing.assert_allclose(on_card, on_cpu, rtol=1e-10)


def test_analytic_intervals_default_to_the_card(cuda):
    """Built without device=, a tomograph's analytic intervals keep their
    tensors on the card."""
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=64)
    tmg.experiment(2000)
    holder = qtt.HolderInterval(tmg, kind="moment")
    holder.setup()
    assert holder.intervals[0]._design_inv.device.type == "cuda"
    poly = qtt.PolytopeProcessInterval(tmg, n_points=10)
    (lo, hi), _ = poly([0.5, 0.9])
    assert (lo <= hi + 1e-6).all() and max(poly.lp_iterations) <= poly.LP_ITERS


def _mcmc_twins(device):
    """A 1-qubit state and a 1-qubit process tomograph in float64 on
    `device`, with the same counts and estimates on every device."""
    st = qtt.StateTomograph(qtt.GHZ(1), key=71, device="cpu", dtype=torch.float64)
    st.experiment(2000, "proj-set")
    st.point_estimate("lin")
    pt = qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), key=72, device="cpu",
                              dtype=torch.float64)
    pt.experiment(2000)
    pt.point_estimate("lifp")
    from quantpy_tpu_torch import interop

    state = interop.tomograph_from_arrays(**interop.to_numpy(st), device=device,
                                          dtype=torch.float64)
    state.reconstructed_state = st.reconstructed_state
    process = interop.process_tomograph_from_arrays(**interop.to_numpy(pt), device=device,
                                                    dtype=torch.float64)
    process.reconstructed_channel = pt.reconstructed_channel
    return state, process


def _mcmc_targets(device):
    import numpy as np

    from quantpy_tpu_torch.ops.cholesky import np_matrix_to_real_tril_vec

    state, process = _mcmc_twins(device)
    mat = state.reconstructed_state.matrix + 1e-7 * np.eye(2)
    choi = process.reconstructed_channel.choi.bloch
    kraus = qtt.MHMCProcessInterval(process, parametrization="kraus", mode_seek=0,
                                    curv_probes=0)
    projected = qtt.MHMCProcessInterval(process, proposal="mala", mode_seek=0)
    return {
        "state": (lambda x: -2000.0 * state._nll(x),
                  np_matrix_to_real_tril_vec(mat / np.trace(mat).real)),
        "bloch": (lambda y: -process._nll(y), choi),
        "kraus": kraus._kraus_target(choi, 1.0),
        "projected": projected._projected_target(choi, 1.0),
    }


@pytest.mark.parametrize("name", ["state", "bloch", "kraus", "projected"])
def test_mcmc_targets_and_drifts_on_the_card_match_the_cpu(cuda, name):
    import numpy as np

    from quantpy_tpu_torch import mhmc

    (target, start), (cpu_target, _) = _mcmc_targets(cuda)[name], _mcmc_targets("cpu")[name]
    start = np.asarray(torch.as_tensor(start).cpu(), dtype=np.float64)
    xs = start + 1e-3 * np.random.default_rng(73).normal(size=(3,) + start.shape)
    value, drift = mhmc._value_and_grad(target, torch.as_tensor(xs, device=cuda))
    cpu_value, cpu_drift = mhmc._value_and_grad(cpu_target, torch.as_tensor(xs))
    assert value.device.type == "cuda"
    for a, b in ((value, cpu_value), (drift, cpu_drift)):
        assert float((a.cpu() - b).abs().max()) <= TOL[torch.float64] * (1 + float(b.abs().max()))


@pytest.mark.parametrize("mala", [False, True])
def test_mcmc_steps_on_the_card_match_the_cpu(cuda, mala):
    """30 MH steps of the state target, or 30 MALA steps of the anchored
    kraus target, from one set of draws: the same states and acceptances."""
    import numpy as np

    from quantpy_tpu_torch import mhmc

    name, step = ("kraus", 6e-3) if mala else ("state", 0.02)
    runs = []
    for device in (cuda, torch.device("cpu")):
        target, start = _mcmc_targets(device)[name]
        x = torch.as_tensor(np.asarray(torch.as_tensor(start).cpu()), device=device)
        rng = np.random.default_rng(74)
        drift_fn = mhmc.autograd_drift(target)
        logp, drift = mhmc._value_and_drift(target, drift_fn, x)
        states, accepted = [], 0
        for _ in range(30):
            delta = torch.as_tensor(rng.normal(size=tuple(x.shape)), device=device)
            log_u = torch.log(torch.as_tensor(rng.uniform(), device=device))
            if mala:
                x, logp, drift, acc = mhmc.mala_step(x, logp, drift, delta, log_u, target,
                                                     drift_fn, step)
            else:
                x, logp, acc = mhmc.mh_step(x, logp, delta, log_u, target,
                                            mhmc.normalized_update, step)
            states.append(x.cpu())
            accepted += int(acc)
        runs.append((torch.stack(states), accepted))
    assert runs[0][1] == runs[1][1] and 0 < runs[0][1] < 30
    assert float((runs[0][0] - runs[1][0]).abs().max()) <= TOL[torch.float64]


def test_mcmc_intervals_default_to_the_card(cuda):
    """Built without device=, the MCMC intervals' chains and their outputs
    live on the card, in float32, and launch no RrhoR kernel."""
    import numpy as np

    tmg = qtt.StateTomograph(qtt.GHZ(2), key=75)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("lin")
    before = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    iv = qtt.MHMCStateInterval(tmg, n_points=40, burn_steps=20, n_chains=2)
    dist, _ = iv([0.5, 0.9])
    assert iv.chain.x_t.device.type == "cuda" and iv.chain.x_t.dtype == torch.float32
    assert np.all(np.isfinite(dist))
    ptmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), key=76)
    ptmg.experiment(2000)
    ptmg.point_estimate("lifp")
    piv = qtt.MHMCProcessInterval(ptmg, n_points=20, burn_steps=10, parametrization="kraus",
                                  proposal="mala", mode_seek=20, curv_probes=4,
                                  return_samples=True)
    dist, _, _, mats = piv.setup()
    assert piv.chain.x_t.device.type == "cuda" and np.all(np.isfinite(dist))
    assert qtt.Channel(qtt.Qobj(mats[-1])).is_cptp(atol=1e-5, verbose=False)
    rho, radius, _ = qtt.bayesian_mean_estimate(tmg, n_samples=20, n_chains=2, burn_steps=20)
    assert rho.is_density_matrix(verbose=False) and np.isfinite(radius)
    assert (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches) == before


def _record(name):
    import json
    from pathlib import Path

    with open(Path(__file__).resolve().parents[1] / "examples" / "data" / name) as fp:
        return json.load(fp)


def test_state_cli_on_the_card(cuda):
    """In float32 the CLI's bootstrap hands B1 one batch; in float64 every
    deterministic output equals the CPU's."""
    import numpy as np

    from quantpy_tpu_torch import config
    from quantpy_tpu_torch.cli import process_interval, state_interval

    doc = _record("ghz2_state_record.json")
    before = kernels.rhor_mle.launches
    out = state_interval.run(doc, method="mle-rhor", interval="bootstrap", n_points=256,
                             device="cuda")
    assert kernels.rhor_mle.launches == before + 1
    assert np.all(np.isfinite(out["hs_radius"])) and np.all(np.diff(out["hs_radius"]) >= 0)
    prev = config.rdtype()
    config.set_dtype(torch.float64)
    try:
        for method, interval in (("lin", "sugiyama"), ("mle-rhor", "polytope")):
            card = state_interval.run(doc, method=method, interval=interval, device="cuda")
            cpu = state_interval.run(doc, method=method, interval=interval, device="cpu")
            for key in cpu:
                assert np.abs(np.subtract(card[key], cpu[key])).max() <= 1e-10, key
        pdoc = _record("cnot2_process_record.json")
        card = process_interval.run(pdoc, device="cuda")
        cpu = process_interval.run(pdoc, device="cpu")
        for key in cpu:
            assert np.abs(np.subtract(card[key], cpu[key])).max() <= 1e-10, key
    finally:
        config.set_dtype(prev)


def test_resumable_bootstrap_on_the_card(cuda, tmp_path):
    """Resumed equals uninterrupted, bit for bit; each float32 chunk is one
    B1 launch; a trace of a chunk names the kernel."""
    import numpy as np

    from quantpy_tpu_torch.utils import resumable_bootstrap, trace

    tmg = qtt.StateTomograph(qtt.GHZ(2), key=81)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("mle-rhor")
    before = kernels.rhor_mle.launches
    full = resumable_bootstrap(str(tmp_path / "a.npz"), tmg, 96, chunk_size=32,
                               method="mle-rhor", seed=5)
    assert kernels.rhor_mle.launches == before + 3
    resumable_bootstrap(str(tmp_path / "b.npz"), tmg, 64, chunk_size=32, method="mle-rhor",
                        seed=5)
    resumed = resumable_bootstrap(str(tmp_path / "b.npz"), tmg, 96, chunk_size=32,
                                  method="mle-rhor", seed=5)
    np.testing.assert_array_equal(resumed, full)
    with trace(str(tmp_path / "trace")):
        resumable_bootstrap(str(tmp_path / "c.npz"), tmg, 32, chunk_size=32,
                            method="mle-rhor")
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    assert "rhor_mle_kernel" in path.read_text()


def test_stage_timer_synchronizes_the_card(cuda):
    """A stage ends only after the card has finished the work queued in it."""
    from quantpy_tpu_torch.utils import StageTimer

    a = torch.randn(2048, 2048, device=cuda)
    timer = StageTimer()
    assert timer.device.type == "cuda"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with timer.stage("matmuls"):
        start.record()
        for _ in range(50):
            a = a @ a / 2048
        end.record()
    assert end.query()  # the stage waited for the card
    assert timer.stages["matmuls"] >= 0.9 * start.elapsed_time(end) / 1e3


def test_bench_headline_launches_the_lane_kernel_once_per_call(cuda, monkeypatch):
    """The benchmark's headline call at 1,024 resamples hands B1 one batch
    and leaves finite distances on the card; its timed section launches it
    once more per call."""
    import numpy as np

    from quantpy_tpu_torch import bench

    monkeypatch.setattr(bench, "N_POINTS", 1024)
    run, design = bench.flagship_call(cuda, "test")
    assert design == (81, 16)
    before = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    d = run()
    torch.cuda.synchronize()
    assert (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches) == (
        before[0] + 1, before[1])
    assert d.device.type == "cuda" and d.shape == (1024,) and bool(torch.isfinite(d).all())
    times, sample = bench.headline(run, cuda, "test")
    assert kernels.rhor_mle.launches == before[0] + 2 + bench.HEADLINE_REPS
    assert len(times) == bench.HEADLINE_REPS and np.isfinite(sample).all()


def test_chain_sampler_on_the_card(cuda):
    """method='chain' on the card: exact totals, zero outcomes kept, the
    per-outcome mean within 5 standard errors, and a B1 estimate of its
    counts equal to the plain loop's."""
    from quantpy_tpu_torch.ops.sampling import sample_multinomial

    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    p = torch.tensor([0.05, 0.0, 0.25, 0.2, 0.5], dtype=torch.float64, device=cuda)
    counts = sample_multinomial(gen, 1000.0, p, shape=(20_000,), method="chain")
    assert counts.device.type == "cuda" and counts.shape == (20_000, 5)
    assert torch.all(counts.sum(-1) == 1000.0) and torch.all(counts[:, 1] == 0)
    se = (1000.0 * p * (1 - p) / 20_000).sqrt()
    assert torch.all((counts.mean(0) - 1000.0 * p).abs() <= 5 * se + 1e-12)

    n, batch = 2, 64
    povm = torch.as_tensor(qtt.generate_measurement_matrix("proj-set", n), dtype=torch.float32,
                           device=cuda)
    n_meas = torch.full((povm.shape[0],), 2000.0, dtype=torch.float32, device=cuda)
    probs = state_core.experiment_probabilities(
        povm, qtt.GHZ(n).bloch_tensor(cuda, torch.float32).expand(batch, -1))
    counts = sample_multinomial(gen, n_meas, probs, method="chain")
    assert torch.all(counts.sum(-1) == 2000.0)
    d = 2**n
    init = state_core.estimate_lin(counts, povm, n_meas)
    bloch0 = state_core._mixed_start(init, d, 0.05).contiguous()
    freq = counts.reshape(batch, -1)
    freq = (freq / freq.sum(-1, keepdim=True)).contiguous()
    a2 = (state_core.weighted_povm_flat(povm, n_meas) * d).contiguous()
    via_kernel = kernels.rhor_mle(freq, bloch0, a2, 40)
    via_plain = kernels.rhor_mle_reference(freq, bloch0, a2, 40)
    assert float((via_kernel - via_plain).abs().max()) <= TOL[torch.float32]


# -- the PSD projection kernel (csrc/psd_project.cu) -----------------------------


def _hermitian_batch(device, d, batch, seed):
    """Random Hermitian complex64 matrices, Hermitian only up to rounding."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, d, d, dtype=torch.complex64, generator=gen)
    return ((x + x.conj().transpose(-1, -2)) + 1e-7 * x).to(device)


def _eigh_projection(a):
    evals, evecs = torch.linalg.eigh(a)
    evals = evals.clamp(min=1e-12)
    return (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)


@pytest.mark.parametrize("batch", [1, 64, 4096])
@pytest.mark.parametrize("d", [4, 16, 64])
def test_psd_kernel_matches_plain_and_eigh(cuda, d, batch):
    a = _hermitian_batch(cuda, d, batch, seed=d + batch)
    before = kernels.psd_project.launches
    sweeps = torch.zeros(batch, dtype=torch.int32, device=cuda)
    out = kernels._psd_launch(a, sweeps)
    torch.cuda.synchronize()
    assert int(sweeps.max()) < kernels.PSD_MAX_SWEEPS
    scale = a.abs().amax((-2, -1), keepdim=True)
    for ref in (kernels.psd_project_reference(a), _eigh_projection(a)):
        assert float(((out - ref).abs() / scale).max()) <= TOL[torch.float32]
    assert torch.equal(kernels.psd_project(a), out)
    assert kernels.psd_project.launches == before + 1


def _dykstra_counts():
    """The counts of the `qt.dykstra` spans of the newest profiler session."""
    from quantpy_tpu_torch.utils import profiling

    return [s.counts for s in profiling.recorded() if s.name == "qt.dykstra"]


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_psd_kernel_once_per_dykstra_step_of_the_three_qubit_interval(cuda):
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 3), input_states="sic", key=55,
                               dtype=torch.float32)
    tmg.experiment(1000, "proj-set")
    tmg.point_estimate("lifp")
    before = kernels.psd_project.launches
    interval = qtt.BootstrapProcessInterval(tmg, n_points=64, cp_engine="eigh", key=3)
    with _cpu_profile():
        interval.setup()
    torch.cuda.synchronize()
    steps = sum(c["iters"] for c in _dykstra_counts())
    assert steps >= 10
    assert kernels.psd_project.launches - before == steps
    assert bool(torch.isfinite(torch.as_tensor(interval.distances)).all())


def _depol3_raw(device, batch, seed):
    """Unprojected lifp estimates of the 3-qubit depolarizing channel on SIC
    inputs at 1,000 shots, float32: `batch` multinomial resamples of one
    experiment, or (batch None) the experiment's own, as its point estimate
    projects it."""
    import numpy as np

    from quantpy_tpu_torch.tomography import process_core

    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 3), input_states="sic", key=seed,
                               dtype=torch.float32)
    tmg.experiment(1000, "proj-set")
    counts, *design = tmg._design()
    if batch is not None:
        c = counts.double().cpu().numpy()
        drawn = np.random.default_rng(seed).multinomial(
            c.sum(-1).astype(np.int64), c / c.sum(-1, keepdims=True), size=(batch,) + c.shape[:-1])
        counts = torch.as_tensor(drawn, dtype=torch.float32, device=device)
    return process_core.estimate_lifp_factored(counts, *design, cptp=False)


@pytest.mark.parametrize("batch", [64, None])
def test_dykstra_graph_replays_the_eager_steps(cuda, batch, monkeypatch, record_property):
    from quantpy_tpu_torch.tomography import process_core

    x = _depol3_raw(cuda, batch, seed=57)
    zeros = torch.zeros_like(x)
    tol = process_core.default_cptp_tol(1e-11, x.dtype)
    assert process_core._graph_route(x, "eigh")

    def run():
        before = kernels.psd_project.launches
        with _cpu_profile():
            out = process_core._dykstra_run(x, zeros, zeros, 2000, 1, tol, "eigh", 19)
        torch.cuda.synchronize()
        (counts,) = _dykstra_counts()
        assert kernels.psd_project.launches - before == counts["iters"]  # one per step
        return out, counts

    with monkeypatch.context() as m:
        m.setattr(process_core, "_graph_route", lambda x, cp: False)
        eager, eager_counts = run()
    assert eager_counts["graph"] == 0 and "captures" not in eager_counts
    first, first_counts = run()  # captures, unless an earlier test ran this shape
    again, again_counts = run()
    iters = eager_counts["iters"]
    assert 10 <= iters < 2000
    assert first_counts["iters"] == iters and first_counts["graph"] >= iters - 1
    assert first_counts.get("captures", 0) == iters - first_counts["graph"]
    assert "captures" not in again_counts and again_counts["graph"] == again_counts["iters"] == iters
    assert again_counts["host_sync"] == eager_counts["host_sync"] == iters
    errs = [max(float((a - b).abs().max()) for a, b in zip(out, eager)) for out in (first, again)]
    record_property("max_diff_graph_vs_eager", max(errs))
    print(f"batch {batch}: {iters} steps; graph vs eager max |diff| {max(errs):.3e} "
          f"({'bit for bit' if max(errs) == 0 else 'not bit for bit'})")
    assert max(errs) <= 1e-6
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(first, again))  # clones, not buffers


@pytest.mark.parametrize("n, dtype", [(4, torch.float32), (3, torch.float64)])
def test_psd_kernel_not_launched_for_four_qubits_or_complex128(cuda, n, dtype):
    from quantpy_tpu_torch.tomography import process_core

    choi = torch.as_tensor(qtt.depolarizing(0.1, n).choi.bloch, dtype=dtype, device=cuda)
    before = kernels.psd_project.launches
    proj = process_core.cp_project_bloch(choi[None] + 1e-3)
    torch.cuda.synchronize()
    assert kernels.psd_project.launches == before
    assert proj.dtype == dtype and proj.device.type == "cuda"


@pytest.mark.parametrize("bad", ["complex128", "d65", "strided"])
def test_psd_kernel_raises_instead_of_falling_back(cuda, bad):
    a = {
        "complex128": torch.zeros(2, 16, 16, dtype=torch.complex128, device=cuda),
        "d65": torch.zeros(2, 65, 65, dtype=torch.complex64, device=cuda),
        "strided": torch.zeros(2, 16, 32, dtype=torch.complex64, device=cuda)[..., :16],
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        kernels.psd_project(a)


# -- the eigenvalue clip kernel (csrc/psd_clip.cu) --------------------------------


def _eigh_clip(a):
    """make_feasible_bloch's eigh clip: eigenvalues floored at 1e-15 and
    divided by their sum, recomposed."""
    evals, evecs = torch.linalg.eigh(a)
    evals = evals.clamp(min=1e-15)
    evals = evals / evals.sum(-1, keepdim=True)
    return (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)


def _clip_states(device, d, batch, seed):
    """(batch, d, d) complex128 Hermitian inputs of trace 1 on the card,
    half their eigenvalues negative: for d = 128 and 256, linear-inversion
    estimates of the 7- and 8-qubit W state from 100 shots a setting (the
    first up to 4), the rest random."""
    import numpy as np

    from benchmark.reference import kron_state as ref

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, d, d)) + 1j * rng.normal(size=(batch, d, d))
    a = (x + x.conj().transpose(0, 2, 1)) / (4 * d) + np.eye(d) / d
    if d in (128, 256):
        n, w = d.bit_length() - 1, min(batch, 4)
        probs = ref.probabilities(torch.as_tensor(ref.bloch_of_ket(ref.w_ket(n))), n).numpy()
        counts = torch.as_tensor(np.stack([ref.draw_counts(rng, probs, 100) for _ in range(w)]))
        a[:w] = ref.bloch_to_matrix(ref.lin(ref.frequencies(counts), n, physical=False), n).numpy()
    return torch.as_tensor(a, dtype=torch.complex128).to(device)


@pytest.mark.parametrize("batch", [1, 9, 19, 256])
@pytest.mark.parametrize("d", [65, 128, 256])
def test_clip_kernel_matches_plain_and_eigh(cuda, d, batch):
    a = _clip_states(cuda, d, batch, seed=d + batch).to(torch.complex64)
    before = kernels.psd_clip.launches
    sweeps = torch.zeros(batch, dtype=torch.int32, device=cuda)
    out = kernels._clip_launch(a, sweeps)
    torch.cuda.synchronize()
    assert int(sweeps.max()) < kernels.PSD_MAX_SWEEPS
    scale = a.abs().amax((-2, -1), keepdim=True)
    for ref in (kernels.psd_clip_reference(a), _eigh_clip(a)):
        assert float(((out - ref).abs() / scale).max()) <= TOL[torch.float32]
    assert torch.equal(kernels.psd_clip(a), out)
    assert kernels.psd_clip.launches == before + 1


@pytest.mark.parametrize("batch", [1, 19])
@pytest.mark.parametrize("d", [65, 128, 256])
def test_clip_kernel_as_accurate_as_the_float32_eigh_clip(cuda, d, batch, record_property):
    a64 = _clip_states(cuda, d, batch, seed=7 * d + batch)
    a = a64.to(torch.complex64)
    exact = _eigh_clip(a64)
    out = kernels.psd_clip(a)
    kernel_err = float((out.to(torch.complex128) - exact).abs().max())
    eigh_err = float((_eigh_clip(a).to(torch.complex128) - exact).abs().max())
    record_property("max_err_kernel", kernel_err)
    record_property("max_err_eigh_f32", eigh_err)
    print(f"d={d} B={batch}: max|clip - float64 clip| kernel {kernel_err:.3e}, "
          f"float32 eigh {eigh_err:.3e}")
    assert kernel_err <= 2 * eigh_err
    trace = out.diagonal(dim1=-2, dim2=-1).sum(-1)
    assert float((trace.real - 1).abs().max()) <= 1e-5
    assert float(trace.imag.abs().max()) <= 1e-5
    assert float(torch.linalg.eigvalsh(out.to(torch.complex128)).min()) >= -1e-6


def test_kron_lin_at_eight_qubits_clips_in_the_kernel(cuda):
    import numpy as np

    from quantpy_tpu_torch.tomography import kron_core
    from quantpy_tpu_torch.utils import profiling

    from benchmark.reference import kron_state as ref

    n, batch = 8, 3
    probs = ref.probabilities(torch.as_tensor(ref.bloch_of_ket(ref.w_ket(n))), n).numpy()
    rng = np.random.default_rng(8)
    counts = np.stack([ref.draw_counts(rng, probs, 100) for _ in range(batch)])
    povm1 = torch.as_tensor(ref.PROJ_SET_1)
    before = kernels.psd_clip.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        est = kron_core.kron_estimate_lin(torch.as_tensor(counts, dtype=torch.float32, device=cuda),
                                          povm1.to(cuda, torch.float32), n)
    torch.cuda.synchronize()
    clips = [s for s in profiling.recorded() if s.name == "qt.kron.lin.clip"]
    assert len(clips) == 1
    assert clips[0].counts.get("clip_kernel") == clips[0].counts.get("eigh") == batch
    assert clips[0].counts.get("launches") == 1 and "host_sync" not in clips[0].counts
    assert kernels.psd_clip.launches == before + 1
    on_cpu = kron_core.kron_estimate_lin(torch.as_tensor(counts), povm1, n)
    assert float((est.double().cpu() - on_cpu).abs().max()) <= 1e-6


@pytest.mark.parametrize("n, dtype", [(4, torch.float32), (8, torch.float64)])
def test_clip_kernel_not_launched_for_16_dimensions_or_float64(cuda, n, dtype):
    bloch = torch.zeros(2, 4**n, dtype=dtype, device=cuda)
    bloch[:, 0] = 2.0**-n
    bloch[:, 1] = 0.5 * 2.0**-n
    before = kernels.psd_clip.launches
    out = state_core.make_feasible_bloch(bloch, n)
    torch.cuda.synchronize()
    assert kernels.psd_clip.launches == before
    assert out.dtype == dtype and out.device.type == "cuda"


@pytest.mark.parametrize("bad", ["complex128", "d64", "d257", "strided"])
def test_clip_kernel_raises_instead_of_falling_back(cuda, bad):
    a = {
        "complex128": torch.zeros(2, 72, 72, dtype=torch.complex128, device=cuda),
        "d64": torch.zeros(2, 64, 64, dtype=torch.complex64, device=cuda),
        "d257": torch.zeros(2, 257, 257, dtype=torch.complex64, device=cuda),
        "strided": torch.zeros(2, 72, 144, dtype=torch.complex64, device=cuda)[..., :72],
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        kernels.psd_clip(a)
