"""The fold of the flat-matrix RrhoR kernel, on the CPU.

The flat kernel keeps the Hermitian state as its D real entries F
(kernels.py::_fold) and reads the folded POVM operands of
`_flat_fold_operands`; `_rhor_mle_flat_folded` states its iteration in
plain PyTorch. Here the fold is held to the unfolded plain version
`rhor_mle_flat_reference` (1e-12 in float64: the same iterates in exact
arithmetic), the operands to a numpy rebuild of the JAX wrapper's G rows
(1e-12), and the folded iteration to quantpy_tpu's flat Pallas kernel in
interpret mode (5e-5, the tolerance of tests/test_kernels.py; the Pallas
kernel computes in float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from quantpy_tpu.ops import kernels as jkernels  # noqa: E402
from quantpy_tpu.ops.paulis import _pauli_transfer_np as jax_ptm  # noqa: E402

from quantpy_tpu_torch.ops import kernels  # noqa: E402

from ._torch_cpu import on_cpu, on_cpu_module  # noqa: E402, F401
from .test_torch_kernels_flat import _problem, _t  # noqa: E402

F32 = torch.float32
F64 = torch.float64


def _hermitian(n, batch, seed):
    """(re, im) of `batch` random Hermitian d x d matrices, row-major (batch, D)."""
    rng = np.random.default_rng(seed)
    d = 2**n
    a = rng.normal(size=(batch, d, d)) + 1j * rng.normal(size=(batch, d, d))
    h = a + a.conj().transpose(0, 2, 1)
    return _t(h.real.reshape(batch, -1), F64), _t(h.imag.reshape(batch, -1), F64)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_unfold_of_fold_is_exact(n):
    re, im = _hermitian(n, 3, seed=n)
    f = kernels._fold(re, im)
    assert f.shape == re.shape
    back_re, back_im = kernels._unfold(f)
    assert torch.equal(back_re, re) and torch.equal(back_im, im)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fold_operands_match_jax_g_rows(n):
    """hw_t and h_d against a numpy fold of the JAX wrapper's g_arr[:K]
    (rebuilt with numpy, as tests/test_torch_kernels_flat.py does)."""
    _, _, w2 = _problem(n, 1, seed=50 + n)
    d, dim2 = 2**n, 4**n
    ptm = jax_ptm(n)
    g_ref = np.concatenate([w2 @ ptm.real.T / d, w2 @ ptm.imag.T / d], axis=1)
    a, e = np.divmod(np.arange(dim2), d)
    h_ref = np.where(a <= e, g_ref[:, np.arange(dim2)], g_ref[:, dim2 + e * d + a])
    w = np.where(a == e, 1.0, 2.0)
    hw_t, h_d, _, _ = kernels._flat_fold_operands(_t(w2, F64), n)
    assert hw_t.shape == (dim2, w2.shape[0]) and h_d.shape == w2.shape
    assert hw_t.is_contiguous() and h_d.is_contiguous()
    np.testing.assert_allclose(hw_t.numpy(), (h_ref * w).T, atol=1e-12)
    np.testing.assert_allclose(h_d.numpy(), d * h_ref, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_entry_and_exit_maps_match_dense_ptm(n):
    """F = bloch0 entry is the fold of the dense PTM map, and F exit / d the
    dense map back of the unfolded state."""
    rng = np.random.default_rng(70 + n)
    d, dim2 = 2**n, 4**n
    ptm_re, ptm_im, ptm_re_t, ptm_im_t = kernels._ptm_parts(n, F64, torch.device("cpu"))
    bloch = _t(rng.normal(size=(4, dim2)), F64)
    _, _, entry, exit_map = kernels._flat_fold_operands(_t(rng.random((3, dim2)), F64), n)
    f = bloch @ entry
    np.testing.assert_allclose(
        f.numpy(), kernels._fold(bloch @ ptm_re_t, bloch @ ptm_im_t).numpy(), atol=1e-12)
    re, im = _hermitian(n, 4, seed=80 + n)
    f = kernels._fold(re, im)
    np.testing.assert_allclose(
        (f @ exit_map / d).numpy(), ((re @ ptm_re + im @ ptm_im) / d).numpy(), atol=1e-12)
    np.testing.assert_allclose((bloch @ entry @ exit_map / d).numpy(), bloch.numpy(), atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_folded_iteration_matches_flat_reference_f64(n):
    freq, bloch0, w2 = (_t(x, F64) for x in _problem(n, 5, seed=90 + n))
    folded = kernels._rhor_mle_flat_folded(freq, bloch0, w2, 40)
    ref = kernels.rhor_mle_flat_reference(freq, bloch0, w2, 40)
    np.testing.assert_allclose(folded.numpy(), ref.numpy(), atol=1e-12)


def test_folded_iteration_matches_flat_reference_f32():
    freq, bloch0, w2 = (_t(x, F32) for x in _problem(4, 5, seed=95, shots=10_000))
    folded = kernels._rhor_mle_flat_folded(freq, bloch0, w2, 40)
    ref = kernels.rhor_mle_flat_reference(freq, bloch0, w2, 40)
    assert folded.dtype == F32
    np.testing.assert_allclose(folded.numpy(), ref.numpy(), atol=5e-5)


@pytest.fixture(scope="module")
def folded_and_pallas():
    """n = 4, proj-set, 10^4 shots, B = 8, 40 iterations: the JAX flat
    kernel in interpret mode and the port's folded iteration."""
    import jax.experimental.pallas as pl

    freq, bloch0, w2 = _problem(4, 8, seed=97, shots=10_000)
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interp_call)
        mp.setattr(jkernels.pl, "pallas_call", interp_call)
        ref = np.asarray(jkernels.rhor_mle_pallas_flat(freq, bloch0, w2, n_iter=40, block_b=128))
    ours = kernels._rhor_mle_flat_folded(_t(freq, F32), _t(bloch0, F32), _t(w2, F32), 40)
    return ours, ref


def test_folded_iteration_matches_pallas_interpret(folded_and_pallas):
    ours, ref = folded_and_pallas
    assert ours.dtype == F32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5)
    np.testing.assert_allclose(ours[:, 0].numpy(), 1 / 16, atol=1e-6)
