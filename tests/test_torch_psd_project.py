"""The PSD projection of `kernels.psd_project` on the CPU: its plain version
(the Jacobi kernel's sweeps in PyTorch) against the projection by
`torch.linalg.eigh` that `process_core._eigh_psd_mat` runs, and the rule
that keeps every CPU tensor on that eigh code.

Tolerances, relative to the largest entry of the input: 5e-5 in complex64
(that of tests/test_torch_cuda.py) and 1e-10 in complex128. The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.ops.paulis import bloch_to_matrix  # noqa: E402
from quantpy_tpu_torch.tomography import process_core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

TOL = {torch.complex64: 5e-5, torch.complex128: 1e-10}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain version runs thousands of small operations; on one thread
    they take a quarter of the CPU time they take on many, and leave the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


DIMS = (4, 16, 64)  # the Choi matrices of 1, 2 and 3 qubits
KINDS = ("random", "negative_and_zero", "depolarizing", "rounding")


def eigh_projection(a):
    """`_eigh_psd_mat`'s eigh code as it stood before the kernel."""
    evals, evecs = torch.linalg.eigh(a)
    evals = evals.clamp(min=1e-12)
    return (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)


def hermitian(kind, d, dtype, seed, batch=3):
    """A (batch, d, d) batch of Hermitian matrices of one kind, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, d, d)) + 1j * rng.normal(size=(batch, d, d))
    if kind == "random":
        a = x + x.conj().transpose(0, 2, 1)
    elif kind == "negative_and_zero":
        # a third of the spectrum negative, a third exactly zero (degenerate)
        u, _ = np.linalg.qr(x)
        lam = np.concatenate([-rng.uniform(0.1, 1.0, d // 3), np.zeros(d // 3),
                              rng.uniform(0.1, 1.0, d - 2 * (d // 3))])
        a = (u * lam) @ u.conj().transpose(0, 2, 1)
    elif kind == "depolarizing":
        # the Choi matrix of depolarizing(0.1, n): one eigenvalue and a d - 1
        # fold degenerate one; a Dykstra iterate is such a matrix plus a little
        n = int(round(np.log(d) / np.log(4)))
        choi = torch.as_tensor(qtt.depolarizing(0.1, n).choi.bloch, dtype=torch.float64)
        a = bloch_to_matrix(choi[None], 2 * n).numpy().repeat(batch, 0)
        noise = 1e-3 * (x + x.conj().transpose(0, 2, 1))
        a[1:] = a[1:] + noise[1:]
    else:  # "rounding": Hermitian only up to the dtype's rounding
        eps = np.finfo(np.float32 if dtype == torch.complex64 else np.float64).eps
        a = x + x.conj().transpose(0, 2, 1) + 4 * eps * x
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("d", DIMS)
def test_plain_version_equals_the_eigh_projection(d, dtype, kind):
    a = hermitian(kind, d, dtype, seed=d)
    out = kernels.psd_project(a)
    ref = eigh_projection(a)
    scale = float(a.abs().max())
    assert out.dtype == a.dtype and out.shape == a.shape
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale
    if kind == "rounding":
        # only the lower triangle is read, as eigh reads it
        low = torch.tril(a, -1)
        mirrored = low + low.conj().transpose(-1, -2) + torch.diag_embed(
            a.diagonal(dim1=-2, dim2=-1).real.to(dtype))
        assert not torch.equal(a, mirrored)
        assert torch.equal(out, kernels.psd_project(mirrored))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("kind", ["random", "depolarizing"])
def test_jacobi_converges_well_under_its_sweep_cap(kind, dtype):
    a = hermitian(kind, 64, dtype, seed=5, batch=2)
    evals, evecs, sweeps = kernels._psd_jacobi(a)
    assert 1 <= sweeps <= 12 < kernels.PSD_MAX_SWEEPS
    eye = torch.eye(64, dtype=dtype)
    assert float((evecs.conj().transpose(-1, -2) @ evecs - eye).abs().max()) <= 100 * TOL[dtype]
    np.testing.assert_allclose(evals.sort(-1).values.numpy(),
                               torch.linalg.eigvalsh(a).numpy(),
                               atol=TOL[dtype] * float(a.abs().max()))


@pytest.mark.parametrize("m", [2, 4, 6, 16, 64])
def test_round_robin_meets_every_pair_once_a_sweep(m):
    p, q = kernels._jacobi_rounds(m)
    assert p.shape == q.shape == (m - 1, m // 2)
    assert np.all(p < q)
    for r in range(m - 1):  # each round's pairs are disjoint
        assert len(set(p[r]) | set(q[r])) == m
    pairs = set(zip(p.ravel().tolist(), q.ravel().tolist()))
    assert len(pairs) == m * (m - 1) // 2


@pytest.mark.parametrize("d", [1, 3, 5])
def test_odd_and_tiny_dimensions(d):
    a = hermitian("random", d, torch.complex128, seed=11)
    assert float((kernels.psd_project(a) - eigh_projection(a)).abs().max()) <= 1e-10 * float(
        a.abs().max())


def test_zero_matrices_project_to_the_floor():
    out = kernels.psd_project(torch.zeros(2, 16, 16, dtype=torch.complex64))
    assert torch.equal(out, 1e-12 * torch.eye(16, dtype=torch.complex64).expand(2, 16, 16))


@pytest.mark.parametrize("bad, error", [
    (torch.zeros(2, 65, 65, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 8, 8, dtype=torch.float32), TypeError),
    (torch.zeros(8, 8, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 8, 16, dtype=torch.complex64).transpose(-1, -2)[:, :8], ValueError),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        kernels.psd_project(bad)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("d", DIMS)
def test_eigh_psd_mat_on_the_cpu_keeps_the_eigh_code(monkeypatch, d, dtype):
    def refuse(a):
        raise AssertionError("psd_project called on a CPU tensor")

    monkeypatch.setattr(kernels, "psd_project", refuse)
    a = hermitian("negative_and_zero", d, dtype, seed=3, batch=4).reshape(2, 2, d, d)
    assert torch.equal(process_core._eigh_psd_mat(a), eigh_projection(a))
