"""The autouse fixtures of the port's CPU test files, and their one thread
policy.

The port's default device is the card; a test file that runs on the CPU
imports `on_cpu` from here (``from ._torch_cpu import on_cpu``), and every
test in it then runs with the CPU as the default device and on one torch
intra-op thread, both restored afterwards. A file whose module-scoped
fixtures compute with torch imports `on_cpu_module` as well, so that they
run under the same policy.

One thread, because the suite runs in several worker processes at once:
with torch's default pool, as wide as the machine, in every worker, the
workers' many small operations contend for the cores and run several
times slower than on one thread each.
"""

import contextlib

import pytest


@contextlib.contextmanager
def cpu_one_thread():
    """The CPU as the port's default device and one torch intra-op thread,
    both restored on exit."""
    import torch

    from quantpy_tpu_torch import config

    prev_device, prev_threads = config.get_device(), torch.get_num_threads()
    config.set_device("cpu")
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev_threads)
        config.set_device(prev_device)


@pytest.fixture(autouse=True)
def on_cpu():
    with cpu_one_thread():
        yield


@pytest.fixture(autouse=True, scope="module")
def on_cpu_module():
    with cpu_one_thread():
        yield
