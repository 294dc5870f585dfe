"""Fixtures of the benchmark's CPU tests: the program's default device set
to the CPU, and a temporary copy of the benchmark with throwaway cells
small enough for the CPU, added as new files and BENCHMARK.json entries
only. Each throwaway cell keeps the limits of the cell it shrinks."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA_DIRS = ("configs", "traffic", "cells")
#: cell: (config, traffic copied, options, chips, the cell whose limits it keeps)
TINY_CELLS = {
    "tiny-rhor": ("ghz2", "rhor16k", {"n_points": 64, "method": "mle-rhor", "max_iter": 10}, 1,
                  "ghz4-rhor16k"),
    "tiny-lin": ("ghz2", "lin1k", {"n_points": 50, "method": "lin", "physical": True}, 1,
                 "ghz4-lin1k"),
    "tiny-process": ("depol1", "qpt64", {"n_points": 16}, 1, "depol3-qpt64"),
    "tiny-mesh": ("ghz2", "rhor64k-mesh4", {"n_points": 64, "method": "mle-rhor", "max_iter": 10},
                  4, "ghz4-rhor64k-mesh4"),
}
TINY_CONFIGS = {
    "ghz2": ("ghz4-projset", {"n_qubits": 2, "n_povms": 9, "n_outcomes": 4, "shots": 1000}),
    "depol1": ("depol3-qpt", {"n_qubits": 1}),
}


@pytest.fixture(autouse=True)
def on_cpu():
    from quantpy_tpu_torch import config

    prev = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(prev)


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def copy_benchmark(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's data files, copied under `dest`."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for d in DATA_DIRS:
        shutil.copytree(REPO / "benchmark" / d, dest / "benchmark" / d)
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark under `dest` with the TINY_CELLS added as
    files and entries; every metric that lists workloads lists them too."""
    root = copy_benchmark(dest)
    base = root / "benchmark"
    for name, (source, changes) in TINY_CONFIGS.items():
        cfg = load(base / "configs" / f"{source}.json")
        cfg.update(changes, name=name)
        dump(cfg, base / "configs" / f"{name}.json")
    manifest = load(root / "BENCHMARK.json")
    for name, (config, traffic, options, chips, limits_of) in TINY_CELLS.items():
        t = load(base / "traffic" / f"{traffic}.json")
        t["options"] = options
        dump(t, base / "traffic" / f"{name}.json")
        limits = load(base / "cells" / f"{limits_of}.json")["limits"]
        dump({"checked_calls": 2, "limits": limits}, base / "cells" / f"{name}.json")
        manifest["workloads"].append(
            {"name": name, "config": config, "traffic": name, "chips": chips, "why": "a CPU test"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
    dump(manifest, root / "BENCHMARK.json")
    return root
