"""Port parity for the estimators and the RrhoR kernel module.

Counts are drawn once with numpy and handed to both packages. The float64
port is held to quantpy_tpu's x64 XLA path at 1e-8; the float32 plain
RrhoR version to the Pallas kernel run in interpret mode at 5e-5, the
tolerance of tests/test_kernels.py (the Pallas kernel computes in float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.ops import kernels as jkernels  # noqa: E402
from quantpy_tpu.tomography import state_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.tomography import state_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

ATOL64 = 1e-8


@pytest.fixture
def float64():
    prev = config.rdtype()
    config.set_dtype(torch.float64)
    yield
    config.set_dtype(prev)


def _design(n, preset="proj-set", shots=1000.0):
    povm = qt.generate_measurement_matrix(preset, n)
    return povm, np.full(povm.shape[0], shots)


def _counts(n, batch, seed, preset="proj-set", shots=1000):
    """Multinomial counts of GHZ(n) drawn with numpy, (batch, m, p)."""
    rng = np.random.default_rng(seed)
    povm, n_meas = _design(n, preset, float(shots))
    probs = np.clip(np.einsum("mod,d->mo", povm, qt.GHZ(n).bloch) * 2**n, 0, 1)
    probs = probs / probs.sum(-1, keepdims=True)
    counts = np.stack(
        [[rng.multinomial(shots, p) for p in probs] for _ in range(batch)]
    ).astype(np.float64)
    return counts, povm, n_meas


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("physical", [False, True])
def test_estimate_lin_matches_jax(float64, physical):
    counts, povm, n_meas = _counts(2, 6, seed=1)
    ours = state_core.estimate_lin(_t(counts), _t(povm), _t(n_meas), physical=physical)
    ref = np.asarray(jcore.estimate_lin(counts, povm, n_meas, physical=physical))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL64)


def test_estimate_lin_unbatched_matches_jax(float64):
    counts, povm, n_meas = _counts(2, 1, seed=2)
    ours = state_core.estimate_lin(_t(counts[0]), _t(povm), _t(n_meas))
    ref = np.asarray(jcore.estimate_lin(counts[0], povm, n_meas))
    assert ours.shape == (16,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL64)


def test_make_feasible_bloch_matches_jax(float64):
    counts, povm, n_meas = _counts(2, 6, seed=3, shots=50)
    raw = np.asarray(jcore.estimate_lin(counts, povm, n_meas, physical=False))
    ours = state_core.make_feasible_bloch(_t(raw), 2)
    ref = np.asarray(jcore.make_feasible_bloch(raw, 2))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL64)
    evals = np.linalg.eigvalsh(qtt.ops.bloch_to_matrix(ours).numpy())
    assert np.all(evals > -1e-12)
    np.testing.assert_allclose(ours[:, 0].numpy(), 0.25, atol=1e-12)


@pytest.mark.parametrize("init", ["lin", "mixed"])
def test_estimate_mle_rhor_matches_jax(float64, init):
    counts, povm, n_meas = _counts(2, 5, seed=4)
    init_bloch = None
    if init == "mixed":
        init_bloch = np.zeros((5, 16))
        init_bloch[:, 0] = 0.25
    ours = state_core.estimate_mle_rhor(
        _t(counts), _t(povm), _t(n_meas),
        None if init_bloch is None else _t(init_bloch), max_iter=50, tol=0.0,
    )
    ref = np.asarray(
        jcore.estimate_mle_rhor(counts, povm, n_meas, init_bloch, max_iter=50, tol=0.0)
    )
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL64)


def test_estimate_dispatch_matches_jax(float64):
    counts, povm, n_meas = _counts(2, 4, seed=5)
    ours = state_core.estimate(_t(counts), _t(povm), _t(n_meas), method="mle-rhor")
    ref = np.asarray(jcore.estimate(counts, povm, n_meas, method="mle-rhor"))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL64)


def test_rhor_reference_matches_pallas_interpret(monkeypatch):
    """n = 4, B = 8, 40 iterations, float32, as tests/test_kernels.py runs it."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    monkeypatch.setattr(jkernels.pl, "pallas_call", interp_call)

    counts, povm, n_meas = _counts(4, 8, seed=7, shots=10_000)
    w2 = np.asarray(jcore.weighted_povm_flat(povm, n_meas)) * 16
    freq = counts.reshape(8, -1)
    freq = freq / freq.sum(-1, keepdims=True)
    init = np.asarray(jcore.estimate_lin(counts, povm, n_meas))
    bloch0 = 0.95 * init
    bloch0[:, 0] += 0.05 / 16

    ref = np.asarray(jkernels.rhor_mle_pallas(freq, bloch0, w2, n_iter=40, block_b=128))
    f32 = torch.float32
    ours = kernels.rhor_mle_reference(_t(freq, f32), _t(bloch0, f32), _t(w2, f32), 40)
    assert ours.dtype == f32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5)
    np.testing.assert_allclose(ours[:, 0].numpy(), 1 / 16, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rhor_mle_on_cpu_runs_the_plain_version(dtype):
    counts, povm, n_meas = _counts(2, 3, seed=8)
    w2 = _t(np.asarray(jcore.weighted_povm_flat(povm, n_meas)) * 4, dtype)
    freq = counts.reshape(3, -1)
    freq = _t(freq / freq.sum(-1, keepdims=True), dtype)
    bloch0 = torch.zeros(3, 16, dtype=dtype)
    bloch0[:, 0] = 0.25
    before = kernels.rhor_mle.launches
    out = kernels.rhor_mle(freq, bloch0, w2, n_iter=12)
    assert kernels.rhor_mle.launches == before
    assert torch.equal(out, kernels.rhor_mle_reference(freq, bloch0, w2, 12))


def _valid_inputs(dtype=torch.float32):
    return (
        torch.full((3, 6), 1 / 6, dtype=dtype),
        torch.tensor([[0.5, 0.0, 0.0, 0.0]] * 3, dtype=dtype),
        torch.full((6, 4), 1.0, dtype=dtype),
    )


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda f, b, w: (f.half(), b.half(), w.half()), TypeError),
        (lambda f, b, w: (f, b.double(), w), ValueError),
        (lambda f, b, w: (f[:, :5].contiguous(), b, w), ValueError),
        (lambda f, b, w: (f, b[:2], w), ValueError),
        (lambda f, b, w: (f, b, w.T.contiguous()), ValueError),
        (lambda f, b, w: (f[None], b, w), ValueError),
        (lambda f, b, w: (f.T.contiguous().T, b, w), ValueError),
        (lambda f, b, w: (f, b[:, :3].contiguous(), w[:, :3].contiguous()), ValueError),
        (lambda f, b, w: (f.numpy(), b, w), TypeError),
    ],
    ids=["half", "mixed-dtype", "K-mismatch", "B-mismatch", "w2-transposed",
         "3-D", "non-contiguous", "D-not-power-of-4", "numpy"],
)
def test_rhor_mle_rejects_what_the_kernel_does_not_take(mutate, error):
    freq, bloch0, w2 = mutate(*_valid_inputs())
    with pytest.raises(error):
        kernels.rhor_mle(freq, bloch0, w2, n_iter=3)


def test_rhor_mle_rejects_bad_iteration_count():
    with pytest.raises(ValueError):
        kernels.rhor_mle(*_valid_inputs(), n_iter=-1)
