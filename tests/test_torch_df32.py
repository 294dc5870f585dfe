"""The port's double-float arithmetic (quantpy_tpu_torch/ops/df32.py)
against quantpy_tpu.ops.df32 and against float64, on the CPU.

The cases mirror tests/test_df32.py. Both packages get the same float32
inputs: the error-free transformations (two_sum, two_prod) equal the JAX
package's bit for bit and are exact against float64; every (hi, lo) result
lies within 2 ulp of the JAX package's hi word and within the accuracy
tests/test_df32.py asks of float64; the gradient of df_log1p_f's hi word
equals JAX's to 1e-6 relative. The JAX package's anchored reduction
(`process_core._rel_nll_from_dp`), which the port replaces by a float64
reduction, is rebuilt from the port's primitives and held to the same
float64 bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from quantpy_tpu.ops import df32 as jdf  # noqa: E402
from quantpy_tpu.tomography import process_core as jcore  # noqa: E402

from quantpy_tpu_torch.ops import df32  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

ULP_LIMIT = 2


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _f64(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def _ulps_apart(ours, ref):
    """|ours - ref| in units of the last place of the float32 `ref`."""
    ref = np.asarray(ref, np.float32)
    spacing = np.spacing(np.abs(ref)).astype(np.float64)
    return np.abs(np.asarray(ours, np.float64) - ref.astype(np.float64)) / spacing


def _div_inputs(rng):
    a = rng.normal(size=4096).astype(np.float32)
    b = np.abs(rng.normal(size=4096)).astype(np.float32) + 1e-6
    return a, b


LOG1P_R = np.concatenate([
    -1.0 + np.logspace(-7, -0.31, 400),
    np.logspace(-8, 11.9, 400),
    -np.logspace(-8, -0.31, 200),
    np.zeros(1),
]).astype(np.float32)


def test_two_sum_exact_and_equal_to_jax(rng):
    a = rng.normal(size=1024).astype(np.float32) * 1e6
    b = rng.normal(size=1024).astype(np.float32)
    s, e = df32.two_sum(_t(a), _t(b))
    js, je = jax.jit(jdf.two_sum)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(_f64((s, e)), a.astype(np.float64) + b)


def test_two_prod_exact_and_equal_to_jax(rng):
    a = rng.normal(size=1024).astype(np.float32) * 1e3
    b = rng.normal(size=1024).astype(np.float32)
    p, e = df32.two_prod(_t(a), _t(b))
    jp, je = jax.jit(jdf.two_prod)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(_f64((p, e)), a.astype(np.float64) * b)


def test_df_div_accuracy_and_jax(rng):
    a, b = _div_inputs(rng)
    ours = df32.df_div_ff(_t(a), _t(b))
    ref = jax.jit(jdf.df_div_ff)(jnp.asarray(a), jnp.asarray(b))
    assert _ulps_apart(ours[0].numpy(), ref[0]).max() <= ULP_LIMIT
    want = a.astype(np.float64) / b
    rel = np.abs(_f64(ours) - want) / np.abs(want)
    assert rel.max() < 1e-13, rel.max()


def test_df_log1p_accuracy_and_jax():
    ours = df32.df_log1p_f(_t(LOG1P_R))
    ref = jax.jit(jdf.df_log1p_f)(jnp.asarray(LOG1P_R))
    assert _ulps_apart(ours[0].numpy(), ref[0]).max() <= ULP_LIMIT
    want = np.log1p(LOG1P_R.astype(np.float64))
    err = np.abs(_f64(ours) - want)
    # relative where the value is O(1)+, absolute floor from the 2^K
    # argument-reduction scale
    tol = 3e-12 * np.maximum(np.abs(want), 1.0)
    assert np.all(err < tol), (err / tol).max()


@pytest.mark.parametrize("name", ["df_add", "df_mul", "df_add_f", "df_mul_f", "df_sqrt"])
def test_pair_arithmetic_matches_jax_and_f64(rng, name):
    """Pairs (x + 1e-8 x', y + 1e-8 y') from two_sum, so lo is a true low
    word."""
    x = df32.two_sum(_t(np.abs(rng.normal(size=2048)) + 0.5), _t(rng.normal(size=2048) * 1e-8))
    y = df32.two_sum(_t(np.abs(rng.normal(size=2048)) + 0.5), _t(rng.normal(size=2048) * 1e-8))
    jx, jy = tuple(jnp.asarray(v.numpy()) for v in x), tuple(jnp.asarray(v.numpy()) for v in y)
    x64, y64 = _f64(x), _f64(y)
    cases = {
        "df_add": ((x, y), (jx, jy), x64 + y64),
        "df_mul": ((x, y), (jx, jy), x64 * y64),
        "df_add_f": ((x, y[0]), (jx, jy[0]), x64 + y[0].double().numpy()),
        "df_mul_f": ((x, y[0]), (jx, jy[0]), x64 * y[0].double().numpy()),
        "df_sqrt": ((x,), (jx,), np.sqrt(x64)),
    }
    args, jargs, want = cases[name]
    ours = getattr(df32, name)(*args)
    ref = jax.jit(getattr(jdf, name))(*jargs)
    assert _ulps_apart(ours[0].numpy(), ref[0]).max() <= ULP_LIMIT
    rel = np.abs(_f64(ours) - want) / np.abs(want)
    assert rel.max() < 1e-13, rel.max()


@pytest.mark.parametrize("n", [1, 1000, 4096, 100_003])
def test_sum2f_matches_jax_and_f64(rng, n):
    x = (rng.normal(size=(3, n)) * 10.0 ** rng.integers(-3, 4, size=(3, n))).astype(np.float32)
    ours = df32.sum2f(_t(x)).numpy()
    ref = np.asarray(jax.jit(jdf.sum2f)(jnp.asarray(x)))
    assert _ulps_apart(ours, ref).max() <= ULP_LIMIT
    want = x.astype(np.float64).sum(-1)
    assert np.all(np.abs(ours - want) <= 2.0**-22 * np.abs(x).astype(np.float64).sum(-1))


@pytest.mark.parametrize("r", [0.5, -0.9, 3e3])
def test_df_log1p_grad_matches_jax(r):
    x = torch.tensor(r, dtype=torch.float32, requires_grad=True)
    df32.df_log1p_f(x)[0].backward()
    ref = float(jax.grad(lambda v: jdf.df_log1p_f(v)[0])(jnp.float32(r)))
    assert np.isfinite(float(x.grad))
    np.testing.assert_allclose(float(x.grad), ref, rtol=1e-6)
    np.testing.assert_allclose(float(x.grad), 1.0 / (1.0 + r), rtol=1e-3)


def _rel_nll_from_dp(dp, counts, p_ref):
    """-sum n log1p(dp / p_ref) from the port's primitives, as the JAX
    package's process_core._rel_nll_from_dp composes them."""
    r_hi, r_lo = df32.df_div_ff(dp, p_ref.clamp(min=1e-12))
    lim = torch.tensor(-1.0 + 1e-7, dtype=r_hi.dtype)
    clamped = r_hi < lim
    r_hi = torch.where(clamped, lim, r_hi)
    r_lo = torch.where(clamped, torch.zeros_like(r_lo), r_lo)
    l_hi, l_lo = df32.df_log1p_f(r_hi)
    l_lo = l_lo + r_lo / (1.0 + r_hi)
    t_hi, t_err = df32.two_prod(counts, l_hi)
    return -df32.sum2f(t_hi, counts * l_lo + t_err)


def _nll_inputs(rng, n):
    p_ref = rng.dirichlet(np.ones(n)).astype(np.float32) + 1e-6
    dp = (rng.normal(size=n) * 0.02 * p_ref).astype(np.float32)
    counts = rng.integers(0, 2000, size=n).astype(np.float32)
    return dp, counts, p_ref


def test_rel_nll_from_dp_matches_f64(rng):
    dp, counts, p_ref = _nll_inputs(rng, 5000)
    got = float(_rel_nll_from_dp(_t(dp), _t(counts), _t(p_ref)))
    r64 = np.maximum(dp.astype(np.float64) / np.maximum(p_ref.astype(np.float64), 1e-12),
                     -1.0 + 1e-7)
    want = -np.sum(counts.astype(np.float64) * np.log1p(r64))
    assert abs(got - want) < 1e-6 * max(abs(want), 1.0) + 1e-4, (got, want)
    ref = float(jax.jit(jcore._rel_nll_from_dp)(jnp.asarray(dp), jnp.asarray(counts),
                                                jnp.asarray(p_ref)))
    assert abs(got - ref) < 1e-6 * max(abs(want), 1.0) + 1e-4, (got, ref)


def test_rel_nll_grad_matches_f64(rng):
    dp, counts, p_ref = _nll_inputs(rng, 512)
    x = _t(dp).requires_grad_(True)
    _rel_nll_from_dp(x, _t(counts), _t(p_ref)).backward()
    want = -counts.astype(np.float64) / (p_ref.astype(np.float64) + dp.astype(np.float64))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=2e-3)
