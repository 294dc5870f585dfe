"""Port parity for the flat-matrix RrhoR kernel module.

Inputs are drawn once with numpy and handed to both packages. The float32
plain flat version is held to quantpy_tpu's flat Pallas kernel run in
interpret mode at 5e-5, the tolerance of tests/test_kernels.py (the Pallas
kernel computes in float32); in float64 the flat and lane plain versions,
which run the same iterates in exact arithmetic, agree to 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.ops import kernels as jkernels  # noqa: E402
from quantpy_tpu.ops.paulis import _pauli_transfer_np as jax_ptm  # noqa: E402
from quantpy_tpu.tomography import bootstrap_core as jboot  # noqa: E402
from quantpy_tpu.tomography import state_core as jcore  # noqa: E402

from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.tomography import bootstrap_core  # noqa: E402

from ._torch_cpu import on_cpu, on_cpu_module  # noqa: E402, F401

F32 = torch.float32
F64 = torch.float64


def _problem(n, batch, seed, shots=1000):
    """(freq, bloch0, w2) as numpy float64: multinomial counts of GHZ(n) on
    proj-set, the JAX package's lin start mixed 5% toward I/d, w2 * d."""
    rng = np.random.default_rng(seed)
    povm = qt.generate_measurement_matrix("proj-set", n)
    n_meas = np.full(povm.shape[0], float(shots))
    probs = np.clip(np.einsum("mod,d->mo", povm, qt.GHZ(n).bloch) * 2**n, 0, 1)
    probs = probs / probs.sum(-1, keepdims=True)
    counts = np.stack(
        [[rng.multinomial(shots, p) for p in probs] for _ in range(batch)]
    ).astype(np.float64)
    d = 2**n
    w2 = np.asarray(jcore.weighted_povm_flat(povm, n_meas)) * d
    freq = counts.reshape(batch, -1)
    freq = freq / freq.sum(-1, keepdims=True)
    bloch0 = 0.95 * np.asarray(jcore.estimate_lin(counts, povm, n_meas))
    bloch0[:, 0] += 0.05 / d
    return freq, bloch0, w2


def _t(x, dtype):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def flagship_flat():
    """n = 4, proj-set, 10^4 shots, B = 8, 40 iterations: the JAX flat
    kernel in interpret mode and the port's plain flat version."""
    import jax.experimental.pallas as pl

    freq, bloch0, w2 = _problem(4, 8, seed=31, shots=10_000)
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interp_call)
        mp.setattr(jkernels.pl, "pallas_call", interp_call)
        ref = np.asarray(
            jkernels.rhor_mle_pallas_flat(freq, bloch0, w2, n_iter=40, block_b=128)
        )
    ours = kernels.rhor_mle_flat_reference(_t(freq, F32), _t(bloch0, F32), _t(w2, F32), 40)
    return ours, ref


def test_flat_reference_matches_pallas_interpret(flagship_flat):
    ours, ref = flagship_flat
    assert ours.dtype == F32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5)
    np.testing.assert_allclose(ours[:, 0].numpy(), 1 / 16, atol=1e-6)


def test_flat_slice_hs_distances_match_jax(flagship_flat):
    """The slice as a whole: both packages' hs distances from their own
    flat outputs to one estimate."""
    ours, ref = flagship_flat
    bloch_est = np.asarray(qt.GHZ(4).bloch, dtype=np.float32)
    d_ref = np.asarray(jboot._distance_batch("hs", ref, bloch_est, 4))
    d = bootstrap_core._distance_batch("hs", ours, _t(bloch_est, F32), 4)
    assert d.shape == (8,) and bool(torch.isfinite(d).all())
    np.testing.assert_allclose(d.numpy(), d_ref, atol=5e-5)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_flat_reference_matches_lane_reference_f64(n):
    """Sizes the JAX flat kernel refuses (D % 128 != 0)."""
    freq, bloch0, w2 = (_t(x, F64) for x in _problem(n, 6, seed=40 + n))
    flat = kernels.rhor_mle_flat_reference(freq, bloch0, w2, 40)
    lane = kernels.rhor_mle_reference(freq, bloch0, w2, 40)
    np.testing.assert_allclose(flat.numpy(), lane.numpy(), atol=1e-10)
    np.testing.assert_allclose(flat[:, 0].numpy(), 1 / 2**n, atol=1e-12)


def test_flat_operands_match_jax_g_rows():
    """G_re and G_im against a numpy rebuild of the JAX wrapper's g_arr[:K]."""
    _, _, w2 = _problem(4, 1, seed=50)
    ptm = jax_ptm(4)
    g_ref = np.concatenate([w2 @ ptm.real.T / 16, w2 @ ptm.imag.T / 16], axis=1)
    g_re, g_im = kernels._flat_operands(_t(w2, F64), 4)
    assert g_re.shape == g_im.shape == w2.shape
    np.testing.assert_allclose(torch.cat([g_re, g_im], 1).numpy(), g_ref, atol=1e-12)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_rhor_mle_flat_on_cpu_runs_the_plain_version(dtype):
    freq, bloch0, w2 = (_t(x, dtype) for x in _problem(2, 3, seed=60))
    before = kernels.rhor_mle_flat.launches
    out = kernels.rhor_mle_flat(freq, bloch0, w2, n_iter=12)
    assert kernels.rhor_mle_flat.launches == before
    assert torch.equal(out, kernels.rhor_mle_flat_reference(freq, bloch0, w2, 12))


def test_rhor_mle_flat_zero_iterations_maps_bloch0_back():
    freq, bloch0, w2 = (_t(x, F64) for x in _problem(2, 3, seed=61))
    out = kernels.rhor_mle_flat(freq, bloch0, w2, n_iter=0)
    np.testing.assert_allclose(out.numpy(), bloch0.numpy(), atol=1e-15)


def _valid_inputs(dtype=F32):
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
        (lambda f, b, w: (f, b, w.to("meta")), ValueError),
        (lambda f, b, w: (f.to("meta"), b.to("meta"), w.to("meta")), ValueError),
        (lambda f, b, w: (f[:, :5].contiguous(), b, w), ValueError),
        (lambda f, b, w: (f, b[:2], w), ValueError),
        (lambda f, b, w: (f, b, w.T.contiguous()), ValueError),
        (lambda f, b, w: (f[None], b, w), ValueError),
        (lambda f, b, w: (f.T.contiguous().T, b, w), ValueError),
        (lambda f, b, w: (f, b.T.contiguous().T, w), ValueError),
        (lambda f, b, w: (f, b[:, :3].contiguous(), w[:, :3].contiguous()), ValueError),
        (lambda f, b, w: (f.numpy(), b, w), TypeError),
    ],
    ids=["half", "mixed-dtype", "mixed-device", "meta-device", "K-mismatch",
         "B-mismatch", "w2-transposed", "3-D", "non-contiguous-freq",
         "non-contiguous-bloch0", "D-not-power-of-4", "numpy"],
)
def test_rhor_mle_flat_rejects_what_the_kernel_does_not_take(mutate, error):
    freq, bloch0, w2 = mutate(*_valid_inputs())
    before = kernels.rhor_mle_flat.launches
    with pytest.raises(error):
        kernels.rhor_mle_flat(freq, bloch0, w2, n_iter=3)
    assert kernels.rhor_mle_flat.launches == before


@pytest.mark.parametrize("n_iter", [-1, 2.0])
def test_rhor_mle_flat_rejects_bad_iteration_count(n_iter):
    with pytest.raises(ValueError):
        kernels.rhor_mle_flat(*_valid_inputs(), n_iter=n_iter)
