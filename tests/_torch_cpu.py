"""The autouse fixture of the port's CPU test files.

The port's default device is the card; a test file that runs on the CPU
imports `on_cpu` from here (``from ._torch_cpu import on_cpu``), and every
test in it then runs with the CPU as the default, restored afterwards.
"""

import pytest


@pytest.fixture(autouse=True)
def on_cpu():
    from quantpy_tpu_torch import config

    prev = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(prev)
