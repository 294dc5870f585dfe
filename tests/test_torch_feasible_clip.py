"""The eigenvalue clip of `kernels.psd_clip` on the CPU: its plain version
(the cluster Jacobi kernel's sweeps in PyTorch) against the clip by
`torch.linalg.eigh` that `state_core.make_feasible_bloch` runs, and the rule
that sends only complex64 states of 65 to 256 dimensions on the card to the
kernel.

Inputs: linear-inversion estimates of the W state from 100 shots per
setting (half their eigenvalues negative), spectra with a third negative
and a third exactly zero, and states that are already positive. Tolerances,
relative to the largest entry of the input: 5e-5 in complex64 (that of
tests/test_torch_cuda.py) and 1e-10 in complex128. The kernel itself runs
only on the card (tests/test_torch_cuda.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.reference import kron_state as ref  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.ops.paulis import bloch_to_matrix, matrix_to_bloch  # noqa: E402
from quantpy_tpu_torch.tomography import state_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

TOL = {torch.complex64: 5e-5, torch.complex128: 1e-10}


def eigh_clip(a):
    """`make_feasible_bloch`'s eigh code on matrices."""
    evals, evecs = torch.linalg.eigh(a)
    evals = evals.clamp(min=1e-15)
    evals = evals / evals.sum(-1, keepdim=True)
    return (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)


def w_linear_estimates(n, batch, seed):
    """(batch, 2^n, 2^n) linear-inversion estimates of the n-qubit W state
    under proj-set at 100 shots per setting, complex128."""
    bloch = torch.as_tensor(ref.bloch_of_ket(ref.w_ket(n)))
    probs = ref.probabilities(bloch, n).numpy()
    rng = np.random.default_rng(seed)
    counts = torch.as_tensor(np.stack([ref.draw_counts(rng, probs, 100) for _ in range(batch)]))
    return ref.bloch_to_matrix(ref.lin(ref.frequencies(counts), n, physical=False), n)


def states(kind, d, dtype, batch=2, seed=0):
    """A (batch, d, d) batch of Hermitian matrices of one kind."""
    rng = np.random.default_rng(seed + d)
    if kind == "w_linear":
        a = w_linear_estimates(int(np.log2(d)), batch, seed).numpy()
    else:
        x = rng.normal(size=(batch, d, d)) + 1j * rng.normal(size=(batch, d, d))
        u, _ = np.linalg.qr(x)
        if kind == "degenerate":
            # a third of the spectrum negative, a third exactly zero
            lam = np.concatenate([-rng.uniform(0.01, 0.1, d // 3), np.zeros(d // 3),
                                  rng.uniform(0.01, 0.1, d - 2 * (d // 3))])
        else:  # "positive": a full-rank state
            lam = rng.uniform(0.1, 1.0, d)
            lam = lam / lam.sum()
        a = (u * lam) @ u.conj().transpose(0, 2, 1)
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


CASES = [(72, "degenerate"), (72, "positive"), (128, "w_linear"), (128, "degenerate"),
         (128, "positive")]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("d, kind", CASES)
def test_plain_version_equals_the_eigh_clip(d, kind, dtype):
    a = states(kind, d, dtype)
    out = kernels.psd_clip(a)
    scale = float(a.abs().max())
    assert out.dtype == a.dtype and out.shape == a.shape
    assert float((out - eigh_clip(a)).abs().max()) <= TOL[dtype] * scale
    trace = out.diagonal(dim1=-2, dim2=-1).sum(-1)
    np.testing.assert_allclose(trace.real.numpy(), 1.0, atol=10 * TOL[dtype])
    assert float(torch.linalg.eigvalsh(out).min()) >= -TOL[dtype] * scale
    if kind == "positive":  # a state is its own clip
        assert float((out - a).abs().max()) <= TOL[dtype] * scale


def test_plain_version_at_eight_qubits_one_state():
    a = states("w_linear", 256, torch.complex128, batch=1, seed=3)
    assert int((torch.linalg.eigvalsh(a) < 0).sum()) >= 100
    assert float((kernels.psd_clip(a) - eigh_clip(a)).abs().max()) <= 1e-10 * float(
        a.abs().max())


def test_plain_version_through_make_feasible_bloch_at_seven_qubits():
    rho = states("w_linear", 128, torch.complex128, batch=2, seed=5)
    bloch = matrix_to_bloch(rho)
    via_plain = matrix_to_bloch(kernels.psd_clip(bloch_to_matrix(bloch, 7)))
    np.testing.assert_allclose(via_plain.numpy(),
                               state_core.make_feasible_bloch(bloch, 7).numpy(), atol=1e-12)


@pytest.mark.parametrize("d, cuda, dtype, takes", [
    (65, True, torch.complex64, True),
    (128, True, torch.complex64, True),
    (256, True, torch.complex64, True),
    (16, True, torch.complex64, False),
    (64, True, torch.complex64, False),
    (257, True, torch.complex64, False),
    (512, True, torch.complex64, False),
    (256, True, torch.complex128, False),
    (256, False, torch.complex64, False),
])
def test_only_complex64_states_of_65_to_256_dimensions_on_the_card_take_the_kernel(
        d, cuda, dtype, takes):
    rho = SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=(3, d, d))
    assert state_core._clips_in_the_kernel(rho) is takes


@pytest.mark.parametrize("n", [4, 9])
def test_make_feasible_bloch_keeps_the_eigh_code_at_16_and_512_dimensions(monkeypatch, n):
    def refuse(a):
        raise AssertionError("psd_clip called")

    monkeypatch.setattr(kernels, "psd_clip", refuse)
    rng = np.random.default_rng(n)
    bloch = torch.as_tensor(rng.normal(scale=1e-3, size=(2, 4**n)))
    bloch[:, 0] = 2.0**-n
    expected = matrix_to_bloch(eigh_clip(bloch_to_matrix(bloch, n)))
    assert torch.equal(state_core.make_feasible_bloch(bloch, n), expected)


@pytest.mark.parametrize("bad, error", [
    (torch.zeros(2, 64, 64, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 257, 257, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 72, 72, dtype=torch.float32), TypeError),
    (torch.zeros(72, 72, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 72, 144, dtype=torch.complex64)[..., :72], ValueError),
])
def test_the_clip_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        kernels.psd_clip(bad)
