"""Port parity: Pauli transforms, POVM presets and Qobj against quantpy_tpu.

Both packages get identical float64 inputs made with numpy; the port runs in
float64 (JAX runs in x64, see conftest.py). Tolerance 1e-12: the same
algorithms in the same precision, differing only in summation order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.ops import paulis as jpaulis  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config  # noqa: E402
from quantpy_tpu_torch.ops import paulis  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

ATOL = 1e-12


@pytest.fixture(autouse=True)
def _float64():
    prev = config.rdtype()
    config.set_dtype(torch.float64)
    yield
    config.set_dtype(prev)


def _random_blochs(n, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, 4**n))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_pauli_transfer_matrix_matches_jax(n):
    ours = paulis.pauli_transfer_matrix(n).numpy()
    ref = np.asarray(jpaulis.pauli_transfer_matrix(n))
    assert ours.dtype == np.complex128
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_bloch_to_matrix_matches_jax(n):
    b = _random_blochs(n, 5, seed=n)
    ours = paulis.bloch_to_matrix(torch.as_tensor(b)).numpy()
    ref = np.asarray(jpaulis.bloch_to_matrix(b, n))
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_allclose(paulis.np_bloch_to_matrix(b), ref, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_matrix_to_bloch_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    d = 2**n
    m = rng.normal(size=(4, d, d)) + 1j * rng.normal(size=(4, d, d))
    m = m + np.swapaxes(m.conj(), -1, -2)
    ours = paulis.matrix_to_bloch(torch.as_tensor(m)).numpy()
    ref = np.asarray(jpaulis.matrix_to_bloch(m))
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_allclose(paulis.np_matrix_to_bloch(m), ref, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ptm_maps_bloch_to_column_stacked_vec(n):
    b = _random_blochs(n, 3, seed=20 + n)
    ptm = paulis.pauli_transfer_matrix(n)
    via_ptm = torch.as_tensor(b).to(ptm.dtype) @ ptm.T
    via_vec = paulis.vec(paulis.bloch_to_matrix(torch.as_tensor(b)))
    np.testing.assert_allclose(via_ptm.numpy(), via_vec.numpy(), atol=ATOL)
    back = paulis.unvec(via_vec)
    np.testing.assert_allclose(back.numpy(), paulis.np_bloch_to_matrix(b), atol=ATOL)


@pytest.mark.parametrize("preset", ["proj", "proj-set", "proj4", "sic"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_povm_presets_match_jax(preset, n):
    ours = qtt.generate_measurement_matrix(preset, n)
    ref = qt.generate_measurement_matrix(preset, n)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("factory", ["GHZ", "zero", "fully_mixed"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_qobj_factories_match_jax(factory, n):
    ours = getattr(qtt, factory)(n)
    ref = getattr(qt, factory)(n)
    np.testing.assert_allclose(ours.bloch, ref.bloch, atol=ATOL)
    np.testing.assert_allclose(ours.matrix, ref.matrix, atol=ATOL)
    t = ours.bloch_tensor()
    assert t.dtype == torch.float64 and t.device.type == "cpu"


def test_qobj_views_and_partial_trace():
    ghz = qtt.GHZ(3)
    assert ghz.is_density_matrix() and ghz.is_pure()
    reduced = ghz.ptrace([0, 2])
    np.testing.assert_allclose(reduced.matrix, qt.GHZ(3).ptrace([0, 2]).matrix, atol=ATOL)
    q = qtt.Qobj(ghz.bloch)
    q.matrix = ghz.matrix
    np.testing.assert_allclose(q.bloch, ghz.bloch, atol=ATOL)
