"""The port's host objects and array helpers against quantpy_tpu on the CPU:
Pauli helpers, ptrace, the least-squares solves, Qobj's added methods,
Basis, the gate library, Channel and the standard channels.

Inputs come from numpy with a seed and go through both packages; float64,
tolerance 1e-8 unless a test says otherwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu import channel as jchannel  # noqa: E402
from quantpy_tpu import models as jmodels  # noqa: E402
from quantpy_tpu import operator as joperator  # noqa: E402
from quantpy_tpu import routines as jroutines  # noqa: E402
from quantpy_tpu.ops import lstsq as jlstsq  # noqa: E402
from quantpy_tpu.ops import paulis as jpaulis  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import channel as tchannel  # noqa: E402
from quantpy_tpu_torch import models as tmodels  # noqa: E402
from quantpy_tpu_torch import operator as toperator  # noqa: E402
from quantpy_tpu_torch import routines as troutines  # noqa: E402
from quantpy_tpu_torch.ops import lstsq, paulis  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

ATOL = 1e-8
F64, C128 = torch.float64, torch.complex128


def _rand_density(rng, dim):
    a = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    rho = a @ a.conj().T
    return rho / np.trace(rho)


def _rand_complex(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_generate_pauli_and_transpose_signs(n):
    ours = paulis.generate_pauli(n, dtype=F64, device="cpu")
    assert ours.dtype == C128 and ours.shape == (4**n, 2**n, 2**n)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jpaulis.generate_pauli(n)), atol=ATOL)
    signs = paulis.pauli_transpose_signs(n)
    np.testing.assert_array_equal(signs, jpaulis.pauli_transpose_signs(n))
    np.testing.assert_allclose(
        ours.transpose(-1, -2).numpy(), signs[:, None, None] * ours.numpy(), atol=ATOL
    )


def test_kron_all_matches_jax():
    rng = np.random.default_rng(0)
    mats = [_rand_complex(rng, 2, 2), _rand_complex(rng, 3, 2), _rand_complex(rng, 2, 4)]
    ours = paulis.kron_all([torch.as_tensor(m) for m in mats])
    np.testing.assert_allclose(ours.numpy(), np.asarray(jpaulis.kron_all(mats)), atol=ATOL)


@pytest.mark.parametrize("n, keep", [(1, (0,)), (2, (0,)), (2, (1,)), (3, (0, 2)), (3, (1,)),
                                     (3, (2, 0, 1))])
def test_ptrace_matches_jax_and_qobj(n, keep):
    rng = np.random.default_rng(n)
    batch = np.stack([_rand_density(rng, 2**n) for _ in range(3)])
    ours = paulis.ptrace(torch.as_tensor(batch), keep).numpy()
    np.testing.assert_allclose(ours, np.asarray(jpaulis.ptrace(batch, keep)), atol=ATOL)
    np.testing.assert_allclose(ours[0], qtt.Qobj(batch[0]).ptrace(keep).matrix, atol=ATOL)


def test_left_inverse_and_lstsq_solve_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 12, 5))
    b_vec = rng.normal(size=(4, 12))
    b_mat = rng.normal(size=(4, 12, 3))
    ta = torch.as_tensor(a)
    np.testing.assert_allclose(
        lstsq.left_inverse(ta).numpy(), np.asarray(jlstsq.left_inverse(a)), atol=ATOL)
    np.testing.assert_allclose(
        lstsq.left_inverse(ta[0]).numpy(), troutines._left_inv(a[0]), atol=ATOL)
    for b in (b_vec, b_mat):
        ours = lstsq.lstsq_solve(ta, torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(ours, np.asarray(jlstsq.lstsq_solve(a, b)), atol=ATOL)
        assert ours.shape == (4, 5) + b.shape[2:]
    assert troutines.left_inv_device is lstsq.left_inverse


def test_routines_match_jax():
    rng = np.random.default_rng(2)
    for ours, ref in zip(troutines.generate_single_entries(3), jroutines.generate_single_entries(3)):
        np.testing.assert_array_equal(ours, ref)
    v = _rand_complex(rng, 2, 9)
    np.testing.assert_array_equal(troutines._vec2mat(v), jroutines._vec2mat(v))
    np.testing.assert_array_equal(troutines._mat2vec(troutines._vec2mat(v)), v)
    np.testing.assert_array_equal(troutines._density(v[0]), jroutines._density(v[0]))
    z = rng.normal(size=(3, 8))
    np.testing.assert_array_equal(troutines._real_to_complex(z), jroutines._real_to_complex(z))
    np.testing.assert_array_equal(troutines._complex_to_real(troutines._real_to_complex(z)), z)
    rho = _rand_density(rng, 4)
    np.testing.assert_allclose(
        troutines._matrix_to_real_tril_vec(rho), jroutines._matrix_to_real_tril_vec(rho), atol=ATOL)
    gates = [toperator.X, toperator.H, toperator.S]
    jgates = [joperator.X, joperator.H, joperator.S]
    np.testing.assert_allclose(
        troutines.join_gates(gates).matrix, jroutines.join_gates(jgates).matrix, atol=ATOL)
    np.testing.assert_allclose(
        troutines.kron(toperator.X, toperator.H).matrix,
        jroutines.kron(joperator.X, joperator.H).matrix, atol=ATOL)
    assert qtt.kron is troutines.kron and qtt.join_gates is troutines.join_gates


def test_qobj_added_methods_match_jax():
    rng = np.random.default_rng(3)
    rho = _rand_density(rng, 4)
    ours, ref = qtt.Qobj(rho), qt.Qobj(rho)
    assert abs(ours.trace() - ref.trace()) < ATOL
    np.testing.assert_allclose(ours.eigh()[0], ref.eigh()[0], atol=ATOL)
    np.testing.assert_allclose(np.sort(ours.eig()[0].real), np.sort(ref.eig()[0].real), atol=ATOL)
    with pytest.raises(ValueError):
        ours.ket()
    bell, jbell = qtt.GHZ(2), qt.GHZ(2)
    np.testing.assert_allclose(np.abs(bell.ket()), np.abs(jbell.ket()), atol=ATOL)
    np.testing.assert_allclose(bell.schmidt()[1], jbell.schmidt()[1], atol=ATOL)
    assert ours._repr_latex_() == ref._repr_latex_()
    big = qtt.Qobj(np.diag(np.arange(12.0) * 1234.5))
    assert big._repr_latex_() == qt.Qobj(big.matrix)._repr_latex_()
    assert r"\cdots" in big._repr_latex_()


def test_basis_decompose_compose_round_trip():
    rng = np.random.default_rng(4)
    elements = [_rand_complex(rng, 2, 2) for _ in range(4)]
    ours, ref = qtt.Basis([qtt.Qobj(e) for e in elements]), qt.Basis([qt.Qobj(e) for e in elements])
    np.testing.assert_allclose(ours.gram, ref.gram, atol=ATOL)
    target = _rand_complex(rng, 2, 2)
    coeffs = ours.decompose(qtt.Qobj(target))
    np.testing.assert_allclose(coeffs, ref.decompose(qt.Qobj(target)), atol=ATOL)
    np.testing.assert_allclose(ours.compose(coeffs).matrix, target, atol=ATOL)
    batch = np.stack([_rand_complex(rng, 2, 2) for _ in range(5)])
    np.testing.assert_allclose(ours.decompose_batch(batch), ref.decompose_batch(batch), atol=ATOL)
    np.testing.assert_allclose(ours.decompose_batch(batch)[2], ours.decompose(batch[2]), atol=ATOL)
    custom = qtt.Basis([qtt.Qobj(e) for e in elements],
                       inner_product=lambda a, b: complex(np.sum(a.matrix * b.matrix.conj())))
    np.testing.assert_allclose(custom.decompose(qtt.Qobj(target)), coeffs, atol=ATOL)


GATES = ["Id", "X", "Y", "Z", "H", "T", "S", "CNOT", "CY", "CZ", "SWAP", "ISWAP", "MS",
         "Toffoli", "Fredkin"]


@pytest.mark.parametrize("name", GATES)
def test_constant_gate_equal_as_matrix(name):
    ours, ref = getattr(toperator, name), getattr(joperator, name)
    np.testing.assert_allclose(ours.matrix, ref.matrix, atol=ATOL)
    assert ours.n_qubits == ref.n_qubits
    np.testing.assert_allclose(ours.matrix @ ours.matrix.conj().T, np.eye(2**ours.n_qubits),
                               atol=ATOL)
    assert getattr(tmodels, name) is ours


@pytest.mark.parametrize("name", ["PHASE", "RX", "RY", "RZ"])
def test_parametric_gate_equal_as_matrix(name):
    for theta in (0.0, 0.37, -2.1):
        np.testing.assert_allclose(
            getattr(toperator, name)(theta).matrix, getattr(joperator, name)(theta).matrix,
            atol=ATOL)


def test_operator_transform_trace_and_channel():
    rng = np.random.default_rng(5)
    rho = _rand_density(rng, 4)
    ours = toperator.CNOT.transform(qtt.Qobj(rho))
    np.testing.assert_allclose(ours.matrix, joperator.CNOT.transform(qt.Qobj(rho)).matrix, atol=ATOL)
    assert abs(toperator.MS.trace() - joperator.MS.trace()) < ATOL
    ch = toperator.CNOT.as_channel()
    assert isinstance(ch, qtt.Channel) and ch.is_cptp(verbose=False)
    np.testing.assert_allclose(ch.choi.matrix, joperator.CNOT.as_channel().choi.matrix, atol=ATOL)
    np.testing.assert_allclose(toperator._controlled(toperator.X.matrix), toperator.CNOT.matrix)
    copy = qtt.Operator(toperator.H)
    copy.matrix = np.eye(4)
    assert copy.n_qubits == 2 and toperator.H.n_qubits == 1


def test_choi_to_kraus_reproduces_the_channel():
    rng = np.random.default_rng(6)
    ch, jch = tchannel.amplitude_damping(0.3), jchannel.amplitude_damping(0.3)
    kraus = toperator.choi_to_kraus(ch.choi)
    jkraus = joperator.choi_to_kraus(jch.choi)
    assert len(kraus) == len(jkraus) == 2
    rho = _rand_density(rng, 2)
    out = sum(k.matrix @ rho @ k.matrix.conj().T for k in kraus)
    np.testing.assert_allclose(out, jch.transform(qt.Qobj(rho)).matrix, atol=ATOL)
    for k, jk in zip(kraus, jkraus):  # equal up to the eigenvector's phase
        np.testing.assert_allclose(np.abs(k.matrix), np.abs(jk.matrix), atol=ATOL)


CHANNELS = [
    ("depolarizing", (0.1, 1)), ("depolarizing", (0.3, 2)), ("dephasing", (0.2, 1)),
    ("dephasing", (0.4, 2)), ("amplitude_damping", (0.25,)), ("walsh_hadamard", (1,)),
    ("walsh_hadamard", (2,)),
]


@pytest.mark.parametrize("name, args", CHANNELS)
def test_channel_constructor_matches_jax(name, args):
    ours, ref = getattr(tchannel, name)(*args), getattr(jchannel, name)(*args)
    np.testing.assert_allclose(ours.choi.matrix, ref.choi.matrix, atol=ATOL)
    assert ours.n_qubits == ref.n_qubits and ours.is_cptp(verbose=False)
    assert getattr(tmodels, name) is getattr(tchannel, name)
    assert getattr(qtt, name) is getattr(tchannel, name)
    assert set(tmodels.__all__) == set(jmodels.__all__)


def test_depolarize_matches_jax():
    ours = tchannel.depolarize(tchannel.amplitude_damping(0.5), 0.2)
    ref = jchannel.depolarize(jchannel.amplitude_damping(0.5), 0.2)
    np.testing.assert_allclose(ours.choi.matrix, ref.choi.matrix, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2])
def test_channel_transform_by_kraus_function_and_choi_agree(n):
    rng = np.random.default_rng(7 + n)
    by_func, jref = tchannel.depolarizing(0.35, n), jchannel.depolarizing(0.35, n)
    by_choi = qtt.Channel(by_func.choi.matrix)
    by_kraus = qtt.Channel([k.matrix for k in by_choi.kraus])
    assert by_choi._func is None and by_kraus._choi is None
    rho = _rand_density(rng, 2**n)
    ref = jref.transform(qt.Qobj(rho)).matrix
    for ch in (by_func, by_choi, by_kraus):
        np.testing.assert_allclose(ch.transform(qtt.Qobj(rho)).matrix, ref, atol=ATOL)
        np.testing.assert_allclose(ch.transform(rho).matrix, ref, atol=ATOL)
    np.testing.assert_allclose(by_kraus.choi.matrix, by_func.choi.matrix, atol=ATOL)
    np.testing.assert_allclose(
        qt.Channel(jref.choi.matrix).transform(qt.Qobj(rho)).matrix, ref, atol=ATOL)


def test_is_cptp_reports_both_failures(capsys):
    good = tchannel.depolarizing(0.2, 1)
    assert good.is_cptp()
    not_tp = qtt.Channel(good.choi.matrix * 1.1)
    assert not not_tp.is_cptp()
    assert "Not trace-preserving" in capsys.readouterr().err
    swap_choi = np.eye(4)[[0, 2, 1, 3]] * 1.0  # the transpose map: TP, not CP
    assert not qtt.Channel(swap_choi).is_cptp()
    assert "Not completely positive" in capsys.readouterr().err
    assert qt.Channel(swap_choi).is_cptp(verbose=False) is False


def test_channel_algebra_matches_jax():
    a, b = tchannel.amplitude_damping(0.3), tchannel.dephasing(0.2, 1)
    ja, jb = jchannel.amplitude_damping(0.3), jchannel.dephasing(0.2, 1)
    for ours, ref in (
        (a + b, ja + jb), (a - b, ja - jb), (0.5 * a, 0.5 * ja), (a / 2.0, ja / 2.0),
        (a.T, ja.T), (a.H, ja.H), (a.conj(), ja.conj()), (-a, -ja), (a.kron(b), ja.kron(jb)),
        (a @ b, ja @ jb), (qtt.Channel(a.kraus) @ qtt.Channel(b.kraus),
                           qt.Channel(ja.kraus) @ qt.Channel(jb.kraus)),
    ):
        assert isinstance(ours, qtt.Channel)
        np.testing.assert_allclose(ours.choi.matrix, ref.choi.matrix, atol=ATOL)
    with pytest.raises(TypeError):
        a @ toperator.X
    with pytest.raises(ValueError):
        a @ tchannel.depolarizing(0.1, 2)
    with pytest.raises(ValueError):
        qtt.Channel(lambda rho: rho)
    c = a.copy()
    c.set_func(lambda rho: rho, 1)
    np.testing.assert_allclose(c.choi.matrix, toperator.Id.as_channel().choi.matrix, atol=ATOL)
    c.kraus = [toperator.X.matrix]
    np.testing.assert_allclose(c.choi.matrix, toperator.X.as_channel().choi.matrix, atol=ATOL)
    c.matrix = a.choi.matrix
    assert c == a and c != b and "Choi matrix" in repr(c)
    assert c._repr_latex_() == ja._repr_latex_()
