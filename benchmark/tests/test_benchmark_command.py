"""The command refuses to run without CUDA and never falls back to the
CPU; it prints no result where the program is missing from the checkout."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness

from .conftest import REPO, copy_benchmark

ARGS = ["--workload", "ghz4-lin1k", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def command(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_harness_refuses_without_cuda(no_card):
    with pytest.raises(harness.NoDevice):
        harness.run(REPO, "ghz4-lin1k", 1, 1.0, False, time.monotonic())


def test_harness_refuses_too_few_cards(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(harness.NoDevice, match="needs 4"):
        harness.run(REPO, "ghz4-rhor64k-mesh4", 1, 1.0, False, time.monotonic())


def test_command_prints_no_result_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = command(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_command_prints_no_result_without_the_program(tmp_path):
    root = copy_benchmark(tmp_path)
    shutil.copytree(REPO / "benchmark", root / "benchmark", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(root)
    assert out.returncode != 0 and out.stdout.strip() == ""
