"""The port's default device is the card.

Without `device=`, a tomograph computes on "cuda", and numpy data goes
there. On a host without CUDA that raises, as PyTorch does for a CUDA
tensor; nothing carries on on the CPU. A caller that wants the CPU asks for
it. Every test restores the setting it changes.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config, interop  # noqa: E402


@pytest.fixture
def restore_device():
    prev = config.get_device()
    yield
    config.set_device(prev)


def test_default_device_is_cuda_on_import():
    out = subprocess.run(
        [sys.executable, "-c", "import quantpy_tpu_torch as q; print(q.get_device())"],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout.split()
    assert out == ["cuda"]


def _on_the_default_device(build):
    """`build()` lands on "cuda" where there is a card and raises where
    there is none; it never returns something on the CPU."""
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build()


def test_tomograph_without_device_is_on_the_card_or_raises(restore_device):
    config.set_device("cuda")
    _on_the_default_device(lambda: qtt.StateTomograph(qtt.GHZ(2)))


def test_numpy_data_goes_to_the_card_or_raises(restore_device):
    config.set_device("cuda")
    _on_the_default_device(lambda: config.as_real(np.ones(3)))
    _on_the_default_device(lambda: qtt.GHZ(2).bloch_tensor())


def test_tomograph_from_arrays_follows_the_default(restore_device):
    config.set_device("cuda")
    jtmg = qtt.StateTomograph(qtt.GHZ(1), device="cpu")
    jtmg.experiment(100, "proj")
    arrays = interop.to_numpy(jtmg)
    _on_the_default_device(lambda: interop.tomograph_from_arrays(**arrays))
    assert interop.tomograph_from_arrays(**arrays, device="cpu").device.type == "cpu"


def test_device_cpu_still_works(restore_device):
    config.set_device("cuda")
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=3, device="cpu", dtype=torch.float64)
    tmg.experiment(500, "proj-set")
    est = tmg.point_estimate("mle-rhor", max_iter=20)
    assert tmg.device.type == "cpu" and tmg.generator.device.type == "cpu"
    assert est.is_density_matrix(verbose=False)
    assert tmg.simulate_batch(2).device.type == "cpu"


def test_set_device_cpu_moves_the_default(restore_device):
    config.set_device("cpu")
    assert config.get_device() == torch.device("cpu")
    assert config.as_real(np.ones(3)).device.type == "cpu"
    assert qtt.StateTomograph(qtt.GHZ(1)).device.type == "cpu"
