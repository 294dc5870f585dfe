"""The last public names of the JAX package, ported: the sampler's `shape`
and `method="chain"`, `kron_simulate_chunked`, `channel_l2_moments_kron`'s
`state_chunk`, `estimate_pgdb_factored_host`, the config switches,
`Qobj.bloch_device` and `ops/cplx`, each against the JAX package on the
CPU.

torch and jax.random streams never match bit for bit, so the samplers are
held to the multinomial distribution: exact totals, and the per-outcome
mean and variance within 5 standard errors on a fixed seed (as
tests/test_torch_sampling.py holds the binary split), with the
probabilities taken from the JAX package. Everything deterministic is held
to the JAX package in float64: `channel_l2_moments_kron` to 1e-8 relative
on the JAX probes (1e-12 between state chunkings), the host pgdb to 1e-8,
`bloch_device` to 1e-12, the pair conversions exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu import config as jconfig  # noqa: E402
from quantpy_tpu.measurements import _single_qubit_preset  # noqa: E402
from quantpy_tpu.ops import cplx as jcplx  # noqa: E402
from quantpy_tpu.ops.sampling import sample_multinomial as jax_sample  # noqa: E402
from quantpy_tpu.tomography import kron_analytic as jka  # noqa: E402
from quantpy_tpu.tomography import kron_core as jkc  # noqa: E402
from quantpy_tpu.tomography import process_core as jcore  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config  # noqa: E402
from quantpy_tpu_torch.ops import cplx  # noqa: E402
from quantpy_tpu_torch.ops.sampling import sample_multinomial  # noqa: E402
from quantpy_tpu_torch.tomography import kron_analytic as ka  # noqa: E402
from quantpy_tpu_torch.tomography import kron_core as kc  # noqa: E402
from quantpy_tpu_torch.tomography import process_core as core  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401
from .test_torch_kron_analytic import (  # noqa: E402
    POVM1,
    STATES1_T,
    _channel_experiment,
    _jax_probes,
)
from .test_torch_process_core import _experiment, _t  # noqa: E402

F64 = torch.float64


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _assert_multinomial_moments(counts, n_trials, p):
    """Per-outcome mean n p and variance n p (1 - p) within 5 standard
    errors over the leading axis of `counts` (n_draws, ..., m)."""
    n_draws = counts.shape[0]
    mean_expected = n_trials * p
    var_expected = n_trials * p * (1 - p)
    se_mean = np.sqrt(var_expected / n_draws)
    assert np.all(np.abs(counts.mean(0) - mean_expected) <= 5 * se_mean + 1e-12)
    # standard error of a sample variance, from the binomial fourth moment
    mu4 = var_expected * (1 + 3 * (n_trials - 2) * p * (1 - p))
    se_var = np.sqrt((mu4 - var_expected**2) / n_draws)
    assert np.all(np.abs(counts.var(0, ddof=1) - var_expected) <= 5 * se_var + 1e-12)


# -- sample_multinomial(shape=, method=) -------------------------------------


@pytest.mark.parametrize("method", ["binary", "chain"])
def test_shape_equals_an_explicit_broadcast(method):
    """Bit for bit, and of the JAX package's result shape."""
    probs = torch.tensor(np.random.default_rng(0).dirichlet(np.ones(6), size=3))
    shaped = sample_multinomial(_gen(4), 200.0, probs, shape=(5, 3), method=method)
    explicit = sample_multinomial(_gen(4), 200.0, probs.expand(5, 3, 6), method=method)
    assert torch.equal(shaped, explicit)
    ref = jax.eval_shape(lambda k: jax_sample(k, 200.0, probs.numpy(), shape=(5, 3),
                                              method=method), jax.random.key(4))
    assert shaped.shape == ref.shape == (5, 3, 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_outcomes", [2, 6, 16])
def test_chain_has_exact_totals_and_multinomial_moments(dtype, n_outcomes):
    p = np.random.default_rng(n_outcomes).dirichlet(np.ones(n_outcomes))
    n_trials, n_draws = 500.0, 20_000
    counts = sample_multinomial(_gen(1), n_trials, torch.as_tensor(p, dtype=dtype),
                                shape=(n_draws,), method="chain")
    assert counts.dtype == dtype and counts.shape == (n_draws, n_outcomes)
    counts = counts.double().numpy()
    np.testing.assert_array_equal(counts.sum(-1), n_trials)
    _assert_multinomial_moments(counts, n_trials, p)


def test_chain_keeps_zero_outcomes_and_per_row_totals():
    n_shots = torch.tensor([1000.0, 250.0, 7.0], dtype=F64)
    probs = torch.tensor([[0.5, 0.5, 0.0], [0.2, 0.0, 0.8], [0.0, 1.0, 0.0]], dtype=F64)
    counts = sample_multinomial(_gen(3), n_shots, probs, shape=(64, 3), method="chain")
    np.testing.assert_array_equal(counts.sum(-1).numpy(),
                                  np.broadcast_to(n_shots.numpy(), (64, 3)))
    assert torch.all(counts[..., 0, 2] == 0) and torch.all(counts[..., 1, 1] == 0)
    assert torch.all(counts[..., 2, 1] == 7)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        sample_multinomial(_gen(0), 10.0, torch.full((4,), 0.25), method="poisson")


def test_default_stream_is_unchanged():
    """The binary split's draws for these seeds, recorded before `shape`
    and `method` were added."""
    probs = torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.0], [0.5, 0.25, 0.125, 0.0625, 0.0625]],
                         dtype=F64)
    counts = sample_multinomial(_gen(2026), torch.tensor([1000.0, 37.0], dtype=F64),
                                probs.expand(3, 2, 5))
    assert counts.long().tolist() == [
        [[85, 206, 291, 418, 0], [18, 9, 6, 2, 2]],
        [[98, 172, 305, 425, 0], [18, 13, 3, 3, 0]],
        [[108, 191, 314, 387, 0], [19, 6, 7, 2, 3]],
    ]
    counts = sample_multinomial(_gen(7), 500.0, torch.full((2, 3), 1 / 3))
    assert counts.long().tolist() == [[186, 154, 160], [154, 166, 180]]


# -- kron_simulate_chunked -----------------------------------------------------


def _povm1():
    return torch.as_tensor(np.asarray(_single_qubit_preset("proj-set")), dtype=F64)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_chunked_one_call_is_kron_simulate(n):
    bloch = qtt.GHZ(n).bloch_tensor(dtype=F64).expand(3, -1)
    fused = kc.kron_simulate(_gen(11), _povm1(), bloch, 300.0)
    chunked = kc.kron_simulate_chunked(_gen(11), _povm1(), bloch, 300.0, n_calls=1)
    assert torch.equal(fused, chunked)


@pytest.mark.parametrize("n, n_calls", [(2, None), (3, 4), (3, None)])
def test_chunked_draw_is_the_multinomial_design(n, n_calls):
    """Blocks of the first group's rows (9 blocks of one row at 2 qubits;
    27 rows in 4 blocks or in 27 at 3), each row a multinomial of the JAX
    package's probabilities."""
    n_draws, shots = 4_000, 200.0
    truth = 0.9 * qt.GHZ(n).bloch
    truth[0] = 1 / 2**n
    counts = kc.kron_simulate_chunked(_gen(n), _povm1(), torch.tensor(truth).expand(n_draws, -1),
                                      shots, n_calls=n_calls)
    assert counts.shape == (n_draws, 3**n, 2**n)
    counts = counts.numpy()
    np.testing.assert_array_equal(counts.sum(-1), shots)
    probs = np.asarray(jkc.kron_probs(_single_qubit_preset("proj-set"), n, truth))
    _assert_multinomial_moments(counts, shots, probs / probs.sum(-1, keepdims=True))


# -- channel_l2_moments_kron(state_chunk=) ---------------------------------------


@pytest.mark.parametrize("n, state_chunk", [(1, 1), (2, 3), (2, 7)])
def test_state_chunks_match_the_whole_and_jax(n, state_chunk):
    _, _, freq = _channel_experiment(n, seed=60 + n)
    probes = torch.tensor(_jax_probes(n, 40))
    whole = ka.channel_l2_moments_kron(STATES1_T, POVM1, n, freq, 3000.0, probes=probes,
                                       state_chunk=4**n)
    chunked = ka.channel_l2_moments_kron(STATES1_T, POVM1, n, freq, 3000.0, probes=probes,
                                         state_chunk=state_chunk)
    np.testing.assert_allclose(chunked, whole, rtol=1e-12)
    ref = jka.channel_l2_moments_kron(STATES1_T, POVM1, n, freq, 3000.0, n_probes=40,
                                      state_chunk=state_chunk)
    np.testing.assert_allclose(chunked, ref, rtol=1e-8)


# -- estimate_pgdb_factored_host ---------------------------------------------------


@pytest.mark.parametrize("n, kwargs", [(1, dict(max_iter=30, cptp_iter=300)),
                                        (2, dict(max_iter=6, cptp_iter=150))])
def test_pgdb_host_matches_jax(n, kwargs):
    counts, b, povm, n_meas, _ = _experiment(n, seed=130 + n)
    init = np.array(jcore.estimate_lifp_factored(counts, b, povm, n_meas,
                                                 cptp_iter=kwargs["cptp_iter"]))
    ours = core.estimate_pgdb_factored_host(_t(counts), _t(b), _t(povm), _t(n_meas),
                                            init_bloch=_t(init), **kwargs)
    ref = jcore.estimate_pgdb_factored_host(counts, b, povm, n_meas, init_bloch=init, **kwargs)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-8)
    same = core.estimate_pgdb_factored(_t(counts), _t(b), _t(povm), _t(n_meas),
                                       init_bloch=_t(init), **kwargs)
    assert torch.equal(ours, same)


# -- config switches, Qobj.bloch_device, ops/cplx ------------------------------------


def test_x64_switch_round_trips():
    prev = config.rdtype()
    try:
        config.enable_x64()
        assert config.is_x64() and config.rdtype() == F64 and config.cdtype() == torch.complex128
        config.enable_x64(False)
        assert not config.is_x64() and config.rdtype() == torch.float32
    finally:
        config.set_dtype(prev)


@pytest.mark.parametrize("name, torch_name", [
    ("highest", "highest"), ("float32", "highest"), ("high", "high"),
    ("tensorfloat32", "high"), ("bfloat16_3x", "high"), ("default", "medium"),
    ("bfloat16", "medium"),
])
def test_matmul_precision_names(name, torch_name):
    try:
        config.set_matmul_precision(name)
        assert torch.get_float32_matmul_precision() == torch_name
    finally:
        config.set_matmul_precision()
    assert torch.get_float32_matmul_precision() == "highest"


def test_unknown_matmul_precision_raises():
    with pytest.raises(ValueError, match="unknown matmul precision"):
        config.set_matmul_precision("fastest")
    assert torch.get_float32_matmul_precision() == "highest"


def test_default_device_kind_uses_the_jax_names():
    assert config.default_device_kind() == jconfig.default_device_kind() == "cpu"
    prev = config.get_device()
    try:
        config.set_device("cuda")  # only recorded: no CUDA call is made
        assert config.default_device_kind() == "gpu"
    finally:
        config.set_device(prev)


@pytest.mark.parametrize("make", [lambda: qtt.GHZ(2), lambda: qtt.Qobj(np.diag([0.7, 0.3]))])
def test_bloch_device_matches_jax(make):
    prev = config.rdtype()
    try:
        config.set_dtype(F64)
        ours = make().bloch_device()
    finally:
        config.set_dtype(prev)
    assert ours.dtype == F64 and ours.device.type == "cpu"
    ref = qt.Qobj(make().matrix).bloch_device()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-12, rtol=0)


def test_cplx_round_trips_and_matches_jax():
    rng = np.random.default_rng(5)
    z = rng.normal(size=(3, 4, 4)) + 1j * rng.normal(size=(3, 4, 4))
    prev = config.rdtype()
    try:
        config.set_dtype(F64)
        pair = cplx.to_pair(z)
        from_tensor = cplx.to_pair(torch.as_tensor(z))
    finally:
        config.set_dtype(prev)
    assert pair.shape == (3, 4, 4, 2) and pair.dtype == F64 and pair.device.type == "cpu"
    assert torch.equal(pair, from_tensor)
    np.testing.assert_array_equal(pair.numpy(), np.asarray(jcplx.to_pair(z)))
    np.testing.assert_array_equal(cplx.from_pair(pair), z)
    np.testing.assert_array_equal(cplx.from_pair(pair.numpy()), jcplx.from_pair(pair.numpy()))
    as_complex = cplx.pair_to_complex(pair)
    np.testing.assert_array_equal(as_complex.numpy(), z)
    np.testing.assert_array_equal(as_complex.numpy(),
                                  np.asarray(jcplx.pair_to_complex(pair.numpy())))
    assert torch.equal(cplx.complex_to_pair(as_complex), pair)
    np.testing.assert_array_equal(cplx.complex_to_pair(as_complex.conj()).numpy(),
                                  np.stack([z.real, -z.imag], axis=-1))
    # a strided pair (the re/im axis not last in memory) converts too
    strided = pair.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(cplx.pair_to_complex(strided), as_complex)
