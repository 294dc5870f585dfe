"""The port's entry points (`quantpy_tpu_torch.entry`, the twin of
__graft_entry__.py) on the CPU: the flagship design against the JAX one,
`entry()`'s bootstrap round, the mesh dry run on 4 CPU shards with every
assertion of the JAX dry run, and its refusal without CUDA.

`__graft_entry__` is imported from the repository root on `sys.path`, as
tests/test_example_workflows.py imports the examples; its JAX functions
run on the CPU in float64 (tests/conftest.py). The dry run's chains are
the port's alone (no JAX kraus chain: ~30 s of compiles).
"""

import contextlib
import io
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import __graft_entry__ as jentry  # noqa: E402

from quantpy_tpu_torch import config, entry, interop  # noqa: E402
from quantpy_tpu_torch.parallel import make_mesh  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401


def test_flagship_design_matches_the_jax_one():
    jtmg, jest = jentry._flagship_design(2, 1000)
    tmg, est = entry._flagship_design(2, 1000)
    np.testing.assert_array_equal(tmg.povm_matrix, np.asarray(jtmg.povm_matrix))
    np.testing.assert_array_equal(tmg.n_measurements, np.asarray(jtmg.n_measurements))
    assert tmg.device.type == "cpu" and tmg.results.shape == np.asarray(jtmg.results).shape


def test_lin_on_the_jax_counts_equals_the_jax_estimate():
    jtmg, jest = jentry._flagship_design(2, 1000)
    tmg = interop.tomograph_from_arrays(**interop.to_numpy(jtmg), dtype=torch.float64)
    np.testing.assert_allclose(tmg.point_estimate("lin").bloch, np.asarray(jest.bloch),
                               rtol=0, atol=1e-8)


def test_entry_round_on_the_cpu():
    fn, args = entry.entry(device="cpu")
    gen, bloch, povm, n_meas = args
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    assert gen.initial_seed() == 0
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in args[1:])
    assert (bloch.shape, povm.shape, n_meas.shape) == ((256,), (81, 16, 256), (81,))
    d = fn(*args)
    assert d.shape == (256,) and bool(torch.isfinite(d).all())
    assert 1e-3 <= float(d.median()) <= 2e-2


def test_dryrun_on_four_cpu_shards():
    buf = io.StringIO()
    device = config.get_device()
    with contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert buf.getvalue().startswith("dryrun_multichip OK on 4 devices")
    assert config.get_device() == device


def test_dryrun_refuses_without_cuda_as_make_mesh_does():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh() takes every card")
    with pytest.raises(RuntimeError) as refused:
        make_mesh(4)
    with pytest.raises(RuntimeError) as dryrun:
        entry.dryrun_multichip(4)
    assert str(dryrun.value) == str(refused.value)
