"""The Pauli transfer matrix as signed gathers, the lane kernel's PTM maps.

`kernels._ptm_gather_tables` lists PTM's non-zeros; `_ptm_gather_apply` and
`_ptm_gather_back` are the plain statement of what the CUDA kernel computes
from them. They are held in float64 against the dense products of the
port's PTM and of the JAX package's PTM, on inputs from
np.random.default_rng, at 1e-12 (sums of d = 2^n unit-weight terms in
another order); and one RrhoR run through them against
`rhor_mle_reference` at 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from quantpy_tpu.ops.paulis import _pauli_transfer_np as jax_ptm  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.ops.paulis import _pauli_transfer_np  # noqa: E402
from quantpy_tpu_torch.tomography import state_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

ATOL = 1e-12
CPU = torch.device("cpu")
QUBITS = [1, 2, 3, 4, 5, 6]


def _inputs(n, seed, batch=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, 4**n)) for _ in range(3)]


def _gathered(n, x, t_re, t_im):
    """(x PTM_re^T, x PTM_im^T, t_re PTM_re + t_im PTM_im) by the gathers."""
    tables = kernels._ptm_gather_tables(n, CPU)
    re, im = kernels._ptm_gather_apply(torch.as_tensor(x), tables)
    back = kernels._ptm_gather_back(torch.as_tensor(t_re), torch.as_tensor(t_im), tables)
    return re.numpy(), im.numpy(), back.numpy()


def _dense(ptm, x, t_re, t_im):
    """(x PTM_re^T, x PTM_im^T, t_re PTM_re + t_im PTM_im) as dense complex
    products with the (D, D) PTM, which is never copied (n = 6: 268 MB)."""
    y = (x + 0j) @ ptm.T
    return y.real, y.imag, ((t_re - 1j * t_im) @ ptm).real


@pytest.mark.parametrize("n", QUBITS)
def test_gather_maps_equal_the_dense_products(n):
    x, t_re, t_im = _inputs(n, seed=n)
    ptm = torch.from_numpy(_pauli_transfer_np(n))
    dense = _dense(ptm, *(torch.as_tensor(a) for a in (x, t_re, t_im)))
    for ours, ref in zip(_gathered(n, x, t_re, t_im), dense):
        np.testing.assert_allclose(ours, ref.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", QUBITS)
def test_gather_maps_equal_the_jax_ptm(n):
    x, t_re, t_im = _inputs(n, seed=10 + n)
    for ours, ref in zip(_gathered(n, x, t_re, t_im), _dense(jax_ptm(n), x, t_re, t_im)):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", QUBITS)
def test_every_row_and_column_has_d_entries(n):
    d, d2 = 2**n, 4**n
    fwd, back = kernels._ptm_gather_tables(n, CPU)
    nonzero = _pauli_transfer_np(n) != 0
    for table, mask in ((fwd, nonzero), (back, nonzero.T)):
        assert table.dtype == torch.int32 and table.shape == (d, d2)
        index = (table.long() >> 2).numpy()
        # output i lists d distinct sources, exactly the non-zeros of its line
        for i in range(d2):
            assert sorted(index[:, i]) == list(np.flatnonzero(mask[i]))
        # and every source feeds exactly d outputs
        assert np.all(np.bincount(index.ravel(), minlength=d2) == d)


def _rhor_by_gathers(freq, bloch0, w2, n_iter):
    """`rhor_mle_reference`'s loop with the PTM maps done by the gathers."""
    n, dim = kernels._dims(w2.shape[-1])
    tables = kernels._ptm_gather_tables(n, w2.device)
    mats = tuple(bloch0.shape[:-1]) + (dim, dim)
    bloch = bloch0
    for _ in range(n_iter):
        c = freq / (bloch @ w2.T).clamp(min=kernels.EPS)
        rre, rim = (a.reshape(mats) for a in kernels._ptm_gather_apply(c @ w2, tables))
        pre, pim = (a.reshape(mats) for a in kernels._ptm_gather_apply(bloch, tables))
        sre, sim = rre @ pre - rim @ pim, rre @ pim + rim @ pre
        tre, tim = sre @ rre - sim @ rim, sre @ rim + sim @ rre
        new = kernels._ptm_gather_back(
            tre.reshape(bloch.shape), tim.reshape(bloch.shape), tables) / dim
        bloch = new / (dim * new[..., 0:1])
    return bloch


@pytest.mark.parametrize("n", [2, 4])
def test_rhor_through_the_gathers_matches_the_plain_version(n):
    d = 2**n
    rng = np.random.default_rng(40 + n)
    povm = torch.as_tensor(qtt.generate_measurement_matrix("proj-set", n), dtype=torch.float64)
    n_meas = torch.full((povm.shape[0],), 1000.0, dtype=torch.float64)
    probs = torch.einsum("mod,d->mo", povm, qtt.GHZ(n).bloch_tensor(CPU, torch.float64)) * d
    probs = (probs.clamp(0, 1) / probs.clamp(0, 1).sum(-1, keepdim=True)).numpy()
    counts = torch.as_tensor(np.stack(
        [[rng.multinomial(1000, p) for p in probs] for _ in range(5)]), dtype=torch.float64)
    init = state_core.estimate_lin(counts, povm, n_meas)
    bloch0 = 0.95 * init
    bloch0[:, 0] += 0.05 / d
    freq = counts.reshape(5, -1)
    freq = freq / freq.sum(-1, keepdim=True)
    w2 = state_core.weighted_povm_flat(povm, n_meas) * d
    ours = _rhor_by_gathers(freq, bloch0, w2, 20)
    ref = kernels.rhor_mle_reference(freq, bloch0, w2, 20)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0, atol=1e-10)
    assert float((ours - bloch0).abs().max()) > 1e-4  # the iterations moved
