"""The likelihood-sampling part of process_core (the kraus maps, whiteners,
anchor pack, exact-delta decode, anchored and relative NLLs, the K-FAC
whitener and the differentiable projection) against quantpy_tpu's on the
CPU in float64, and the Hutchinson curvature diagonal of the kraus interval
against the exact Hessian diagonal.

One set of counts, drawn with numpy from a seed, goes through the JAX
function and its counterpart. Tolerance: 1e-8 (the port's float64
reduction against the JAX package's double-float one in x64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from quantpy_tpu.ops.cplx import to_pair  # noqa: E402
from quantpy_tpu.tomography import process_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch.tomography import process_core as core  # noqa: E402
from quantpy_tpu_torch.tomography import state_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

ATOL = 1e-8
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


@pytest.fixture(scope="module")
def setup():
    """A 1-qubit and a 2-qubit experiment (proj4 inputs, proj-set, 400
    shots) of a depolarizing channel, drawn by the port on the CPU, and
    its lifp estimate."""
    out = {}
    rng = np.random.default_rng(7)
    for n in (1, 2):
        tmg = qtt.ProcessTomograph(qtt.depolarizing(0.2, n), key=11 + n, device="cpu",
                                   dtype=F64)
        tmg.experiment(400)
        est = tmg.point_estimate("lifp")
        t0 = tmg.tomographs[0]
        w = state_core.weighted_povm_flat(_t(t0.povm_matrix), _t(t0.n_measurements)).numpy()
        flat = np.concatenate([t.flat_results for t in tmg.tomographs])
        out[n] = dict(b=tmg._input_blochs_t(), w=w, flat=flat, x_hat=est.choi.bloch, rng=rng)
    return out


def test_kraus_maps_and_start(setup):
    for n, s in setup.items():
        d = 4**n
        y0 = core.np_kraus_param_from_choi_bloch(s["x_hat"])
        np.testing.assert_allclose(y0, jcore.np_kraus_param_from_choi_bloch(s["x_hat"]),
                                   atol=ATOL)
        ys = y0 + 0.05 * s["rng"].normal(size=(3, 2, d, d))
        np.testing.assert_allclose(core.kraus_param_to_choi_bloch(_t(ys)).numpy(),
                                   np.asarray(jcore.kraus_param_to_choi_bloch(ys)), atol=ATOL)
        # the start decodes to an exactly TP point next to the estimate
        back = core.kraus_param_to_choi_bloch(_t(y0)).numpy().reshape(d, d)
        np.testing.assert_allclose(back[:, 0], np.eye(d)[0] / 2**n, atol=1e-12)
        np.testing.assert_allclose(back.reshape(-1), s["x_hat"], atol=1e-4)
        a_l, a_r, a_l_inv, a_r_inv = core.kraus_design_whitener(s["b"], s["w"], s["flat"],
                                                                s["x_hat"])
        ref = jcore.kraus_design_whitener(s["b"], s["w"], s["flat"], s["x_hat"])
        for ours, theirs in zip((a_l, a_r, a_l_inv, a_r_inv), ref):
            np.testing.assert_allclose(ours, theirs, atol=ATOL)
        np.testing.assert_allclose(a_l @ a_l_inv, np.eye(d), atol=1e-8)
        np.testing.assert_allclose(
            core.kraus_param_to_choi_bloch_whitened(_t(ys), a_l, a_r).numpy(),
            np.asarray(jcore.kraus_param_to_choi_bloch_whitened(ys, to_pair(a_l), to_pair(a_r))),
            atol=ATOL)


def _anchor(s, n, whiten=True):
    d = 4**n
    y0 = core.np_kraus_param_from_choi_bloch(s["x_hat"])
    m0 = y0[0] + 1j * y0[1]
    a_l = a_r = None
    if whiten:
        a_l, a_r, a_l_inv, a_r_inv = core.kraus_design_whitener(s["b"], s["w"], s["flat"],
                                                                s["x_hat"])
        m0 = a_l_inv @ m0 @ a_r_inv
    z_ref = m0 + 0.02 * (s["rng"].normal(size=(d, d)) + 1j * s["rng"].normal(size=(d, d)))
    return z_ref, a_l, a_r


@pytest.mark.parametrize("whiten", [False, True])
def test_anchor_pack_delta_decode_and_anchored_nll(setup, whiten):
    for n, s in setup.items():
        d = 4**n
        z_ref, a_l, a_r = _anchor(s, n, whiten)
        pack, x_ref = core.np_kraus_anchor_pack(z_ref, a_l, a_r)
        jpack, jx_ref = jcore.np_kraus_anchor_pack(z_ref, a_l, a_r)
        np.testing.assert_allclose(x_ref, jx_ref, atol=ATOL)
        for key, value in pack.items():
            np.testing.assert_allclose(value, np.asarray(jpack[key])[..., 0]
                                       + 1j * np.asarray(jpack[key])[..., 1], atol=ATOL)
        # small offsets take the contraction, large ones the Cholesky branch
        dz = np.concatenate([1e-3 * s["rng"].normal(size=(2, 2, d, d)),
                             2.0 * s["rng"].normal(size=(1, 2, d, d))])
        ours = core.kraus_delta_choi_bloch(_t(dz), core.anchor_pack_to(pack, _t(dz)))
        theirs = np.asarray(jcore.kraus_delta_choi_bloch(dz, jpack))
        np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL)
        # X_ref + dX is the plain decode of the anchor plus the offset
        full = core.kraus_param_to_choi_bloch_whitened(
            _t(np.stack([z_ref.real, z_ref.imag]) + dz),
            np.eye(d) if a_l is None else a_l, np.eye(d) if a_r is None else a_r)
        np.testing.assert_allclose(x_ref + ours.numpy(), full.numpy(), atol=1e-8)
        assert float(core.kraus_delta_choi_bloch(_t(np.zeros((2, d, d))), pack).abs().max()) == 0
        p_ref = d * np.einsum("sa,ab,kb->sk", s["b"], x_ref.reshape(d, d), s["w"]).reshape(-1)
        dzf = dz.reshape(3, -1)
        got = core.process_nll_anchored(_t(dzf), s["b"], s["w"], s["flat"], pack, p_ref)
        want = jax.jit(jcore.process_nll_anchored)(dzf, s["b"], s["w"], s["flat"], jpack, p_ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-12)
        # the anchored NLL is NLL(X) - NLL(X_ref) of the plain factored NLL
        nll = core.process_nll_factored(_t(x_ref + ours.numpy()), s["b"], s["w"], s["flat"])
        nll_ref = core.process_nll_factored(_t(x_ref), s["b"], s["w"], s["flat"])
        np.testing.assert_allclose(got[:2].numpy(), (nll - nll_ref)[:2].numpy(), atol=1e-6)


def test_relative_nll_and_reduction(setup):
    for n, s in setup.items():
        d = 4**n
        x_ref = s["x_hat"]
        p_ref = d * np.einsum("sa,ab,kb->sk", s["b"], x_ref.reshape(d, d), s["w"]).reshape(-1)
        x = x_ref + 1e-3 * s["rng"].normal(size=(4, d * d))
        got = core.process_nll_factored_rel(_t(x), s["b"], s["w"], s["flat"], x_ref, p_ref)
        want = jax.jit(jcore.process_nll_factored_rel)(x, s["b"], s["w"], s["flat"], x_ref, p_ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-12)
        # the shared reduction: float64 whatever dp's dtype, returned in it
        dp = 1e-3 * s["rng"].normal(size=(2, p_ref.size))
        dp[0, 0] = -2.0 * p_ref[0]  # clamped at -1 + 1e-7
        want = np.asarray(jax.jit(jcore._rel_nll_from_dp)(dp, s["flat"], p_ref))
        np.testing.assert_allclose(core._rel_nll_from_dp(_t(dp), s["flat"], p_ref).numpy(),
                                   want, atol=ATOL, rtol=1e-12)
        low = core._rel_nll_from_dp(_t(dp).float(), s["flat"], p_ref)
        assert low.dtype == torch.float32


def test_kron_fisher_whitener(setup):
    for n, s in setup.items():
        ours = core.kron_fisher_whitener(s["b"], s["w"], s["flat"], s["x_hat"])
        theirs = jcore.kron_fisher_whitener(s["b"], s["w"], s["flat"], s["x_hat"])
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, atol=ATOL)
    eye = core.kron_fisher_whitener(s["b"], s["w"], 0 * s["flat"], s["x_hat"])
    assert all(np.array_equal(m, np.eye(16)) for m in eye)


def test_cptp_project_bloch_diff_value_and_gradient(setup):
    s = setup[1]
    x = s["x_hat"] + 0.05 * s["rng"].normal(size=(2, 16))
    ours = core.cptp_project_bloch_diff(_t(x), 12)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jcore.cptp_project_bloch_diff(x, 12)),
                               atol=ATOL)
    # the gradient of the projected-likelihood target
    args = (s["b"], s["w"], s["flat"])
    xt = _t(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(
        core.process_nll_factored(core.cptp_project_bloch_diff(xt, 12), *args).sum(), xt)
    jgrad = jax.jit(jax.grad(
        lambda y: jnp.sum(jcore.process_nll_factored(jcore.cptp_project_bloch_diff(y, 12),
                                                     *args))))(x)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=ATOL, rtol=1e-9)


def test_hutchinson_diagonal_matches_the_exact_hessian(setup):
    """The kraus interval's Hutchinson estimate of the anchored target's
    Hessian diagonal, with 4,000 Rademacher probes, against the exact
    diagonal on 1 qubit: within 10% of the largest entry."""
    from quantpy_tpu_torch.tomography.interval import _hutchinson_diagonal

    s = setup[1]
    z_ref, a_l, a_r = _anchor(s, 1)
    pack, x_ref = core.np_kraus_anchor_pack(z_ref, a_l, a_r)
    p_ref = 4 * np.einsum("sa,ab,kb->sk", s["b"], x_ref.reshape(4, 4), s["w"]).reshape(-1)

    def target(dzf):
        return -core.process_nll_anchored(dzf, s["b"], s["w"], s["flat"], pack, p_ref)

    est = _hutchinson_diagonal(target, 32, 4000, F64, "cpu").numpy()
    hess = torch.autograd.functional.hessian(lambda z: -target(z), torch.zeros(32, dtype=F64))
    exact = torch.diagonal(hess).numpy()
    assert np.max(np.abs(est - exact)) <= 0.1 * np.max(np.abs(exact))


def test_anchored_nll_in_float64_passes_the_jax_packages_checks():
    """The checks tests/test_process_tomography.py makes of the JAX
    package's double-float anchored NLL, made of the port's float64
    reduction: the exact-delta decode equals full(z_ref + dz) - full(z_ref)
    at 1e-10 relative for offsets 0.1, 1e-3 and 1e-6; the NLL equals the
    direct sum at 1e-8 relative; a zero offset gives exactly zero; the
    gradient is finite; and a float32 offset gives the float64 value to
    float32's resolution of the offset."""
    rng = np.random.default_rng(0)
    d, d_in = 16, 4
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    x = a @ a.conj().T
    x = x / np.trace(x).real * d_in
    w_, v_ = np.linalg.eigh(x)
    m_ref = (v_ * np.sqrt(np.clip(w_, 0, None))) @ v_.conj().T
    al = np.eye(d) + 0.1 * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    ar = np.eye(d) + 0.1 * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    z_ref = np.linalg.solve(al, m_ref) @ np.linalg.inv(ar)
    pack, x_ref = core.np_kraus_anchor_pack(z_ref, al, ar)
    for scale in (0.1, 1e-3, 1e-6):
        dz = scale * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
        dbloch = core.kraus_delta_choi_bloch(_t(np.stack([dz.real, dz.imag])), pack).numpy()
        z = z_ref + dz
        direct = core.kraus_param_to_choi_bloch_whitened(
            _t(np.stack([z.real, z.imag])), al, ar).numpy() - x_ref
        np.testing.assert_allclose(dbloch, direct,
                                   atol=1e-10 * max(np.abs(direct).max(), 1e-12) + 1e-13)
    s_, k_ = 5, 7
    b = rng.normal(size=(s_, d))
    wf = rng.normal(size=(k_, d))
    counts = rng.integers(1, 100, size=s_ * k_).astype(np.float64)
    p_ref = np.abs(d * np.einsum("sa,ab,kb->sk", b, x_ref.reshape(d, d), wf)).reshape(-1) + 0.5
    dz = 1e-3 * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    dz_flat = _t(np.stack([dz.real, dz.imag]).reshape(-1))
    nll = float(core.process_nll_anchored(dz_flat, b, wf, counts, pack, p_ref))
    dbl = core.kraus_delta_choi_bloch(_t(np.stack([dz.real, dz.imag])), pack).numpy()
    dp = d * np.einsum("sa,ab,kb->sk", b, dbl.reshape(d, d), wf).reshape(-1)
    manual = -np.sum(counts * np.log1p(np.maximum(dp / p_ref, -1 + 1e-7)))
    assert abs(nll - manual) < 1e-8 * max(abs(manual), 1.0)
    assert float(core.process_nll_anchored(torch.zeros(2 * d * d, dtype=F64), b, wf, counts,
                                           pack, p_ref)) == 0.0
    zz = dz_flat.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(core.process_nll_anchored(zz, b, wf, counts, pack, p_ref), zz)
    assert bool(torch.isfinite(g).all())
    low = core.process_nll_anchored(dz_flat.float(), b, wf, counts, pack, p_ref)
    assert low.dtype == torch.float32
    assert abs(float(low) - nll) < 1e-5 * max(abs(nll), 1.0)
