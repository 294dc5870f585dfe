"""On the card: the control (the reference in the program's place, float32
with TF32 products) fails a limit of each cell's check, and the program
passes them, at sizes a test run holds. Run on the card with
`python -m pytest benchmark/tests -m cuda`; skipped elsewhere."""

from __future__ import annotations

import pytest

from benchmark import calibrate

from .conftest import copy_benchmark, dump, load

#: cell: (resamples per call, calls)
SIZES = {"ghz4-rhor16k": (4096, 2), "ghz4-lin1k": (1000, 2), "depol3-qpt64": (32, 1)}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails_and_program_passes(card, tmp_path, cell):
    root = copy_benchmark(tmp_path)
    base = root / "benchmark"
    manifest = load(root / "BENCHMARK.json")
    traffic = next(w["traffic"] for w in manifest["workloads"] if w["name"] == cell)
    t = load(base / "traffic" / f"{traffic}.json")
    t["options"]["n_points"], calls = SIZES[cell]
    dump(t, base / "traffic" / f"{traffic}.json")
    limits = load(base / "cells" / f"{cell}.json")["limits"]
    for seed in (2**31 + 1, 2**31 + 2):
        r = calibrate.readings(root, cell, seed, calls)
        assert all(r[k] <= limits[k] for k in limits), r
        assert any(r[f"control_{k}"] > limits[k] for k in limits if f"control_{k}" in r), r
