"""The harness driven on the CPU past its look for a card: the throwaway
cells of the conftest (new files and BENCHMARK.json entries only) run and
come out correct, and with the timed path broken underneath each fault
makes `correct` come out false."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import faults, harness
from quantpy_tpu_torch.ops import kernels
from quantpy_tpu_torch.parallel import mesh
from quantpy_tpu_torch.tomography import bootstrap_core, process_core, state_core

from .conftest import REPO, TINY_CELLS, dump, load

SEED = 2**31 + 11


def run(root, cell, trace=False, seconds=0.5):
    return harness.run(root, cell, SEED, seconds, trace, time.monotonic(), device_type="cpu")


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(tiny_root, cell, trace):
    result = run(tiny_root, cell, trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result["checks"])[-1] == "dist_gap"
    assert set(result["checks"]) == {"failed_calls", "exact_faults", "count_mean_z",
                                     "count_var_z", "center_gap", "dist_gap"}
    if not trace:
        assert {"resamples_per_s", "setup_s"} <= set(result["metrics"])
        assert result["metrics"]["resamples_per_s"]["unit"] == "resamples/s"
    else:
        assert "breakdown" in result and "window_s" in result["device"]


def test_same_seed_same_inputs(tiny_root):
    """The experiment and every call's key come from the seed alone."""
    from benchmark.entries import state_interval

    cfg = load(tiny_root / "benchmark" / "configs" / "ghz2.json")
    a, b = state_interval.experiment(cfg, 5), state_interval.experiment(cfg, 5)
    assert np.array_equal(a, b) and not np.array_equal(a, state_interval.experiment(cfg, 6))
    assert harness.derived_seed(2**40 + 3, 1, 7) == harness.derived_seed(2**40 + 3, 1, 7)


def _unchanged_rhor(freq, bloch0, w2, n_iter, tol=None):
    return bloch0


def _unchanged_clip(bloch, n_qubits):
    return bloch


def _half_batch(fn):
    """Estimates of the first half of the resamples only, the second half
    filled with their mean."""
    def broken(counts, *args, **kwargs):
        out = fn(counts, *args, **kwargs)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half].mean(0, keepdim=True).expand_as(out[half:])])
    return broken


def _altered_count(fn):
    def broken(*args, **kwargs):
        counts = fn(*args, **kwargs).clone()
        counts.view(-1)[0] += 1.0
        return counts
    return broken


def _altered_distance(fn):
    def broken(*args, **kwargs):
        d = fn(*args, **kwargs).clone()
        d[0] *= 1.5
        return d
    return broken


def _first_shard_only(msh, parts, dim=0):
    return torch.cat([parts[0].to(msh.devices[0])] * len(parts), dim=dim)


def _one_shard_run(msh, fn):
    """The first shard run once and its result handed out for every shard."""
    first = fn(0)
    return [first] * msh.size


FAULTS = {
    # (cell, module, attribute, replacement(original))
    "rhor step returns its state": ("tiny-rhor", kernels, "rhor_mle_reference",
                                    lambda f: _unchanged_rhor),
    "eigenvalue clip returns its state": ("tiny-lin", state_core, "make_feasible_bloch",
                                          lambda f: _unchanged_clip),
    "half the batch, the mean over the rest": ("tiny-rhor", state_core, "estimate", _half_batch),
    "half the process batch": ("tiny-process", process_core, "estimate_lifp_factored", _half_batch),
    "a count altered": ("tiny-lin", state_core, "simulate_experiment", _altered_count),
    "a distance altered": ("tiny-rhor", bootstrap_core, "_distance_batch", _altered_distance),
    "the gather between cards left out": ("tiny-mesh", mesh, "_gather", lambda f: _first_shard_only),
    "a shard left out before its draw": ("tiny-mesh", mesh, "_run_shards",
                                         lambda f: _one_shard_run),
    "counts without randomness": ("tiny-rhor", state_core, "simulate_experiment",
                                  faults.deterministic),
    "process counts without randomness": ("tiny-process", state_core, "simulate_experiment",
                                          faults.deterministic),
    "counts of the wrong probabilities": ("tiny-lin", state_core, "simulate_experiment",
                                          faults.uniform),
    "process counts of the wrong probabilities": ("tiny-process", state_core,
                                                  "simulate_experiment", faults.uniform),
    "half the resamples drawn and returned": ("tiny-lin", state_core, "simulate_experiment",
                                              faults.half),
    "half the process resamples": ("tiny-process", state_core, "simulate_experiment",
                                   faults.half),
    "half the resamples of each card": ("tiny-mesh", state_core, "simulate_experiment",
                                        faults.half),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_root, monkeypatch, fault):
    cell, module, attr, broken = FAULTS[fault]
    assert run(tiny_root, cell)["correct"] is True
    monkeypatch.setattr(module, attr, broken(getattr(module, attr)))
    result = run(tiny_root, cell)
    assert result["correct"] is False, result["checks"]


def test_new_files_are_enough(tiny_root):
    """A metric and an entry kind added as new files, with a cell that uses
    them, run from a copy of the harness with no edit to any file there."""
    base = tiny_root / "benchmark"
    for f in ("__init__.py", "harness.py", "spans.py", "trace.py", "checks.py", "roofline.py",
              "run.py"):
        (base / f).write_text((REPO / "benchmark" / f).read_text())
    for d in ("entries", "metrics", "reference"):
        for f in (REPO / "benchmark" / d).glob("*.py"):
            (base / d).mkdir(exist_ok=True)
            (base / d / f.name).write_text(f.read_text())
    (base / "metrics" / "calls_done.py").write_text(
        "SPANS = {}\n\n\ndef read(trace, run):\n    return run.calls\n")
    (base / "entries" / "lin_interval.py").write_text(
        "from .state_interval import CAPTURE, Session, readings, verify  # noqa: F401\n")
    t = load(base / "traffic" / "tiny-lin.json")
    t["entry"] = "lin_interval"
    dump(t, base / "traffic" / "tiny-new.json")
    dump(load(base / "cells" / "tiny-lin.json"), base / "cells" / "tiny-new.json")
    manifest = load(tiny_root / "BENCHMARK.json")
    manifest["workloads"].append({"name": "tiny-new", "config": "ghz2", "traffic": "tiny-new",
                                  "chips": 1, "why": "a CPU test"})
    manifest["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["tiny-new"]})
    dump(manifest, tiny_root / "BENCHMARK.json")
    code = ("import json, time; from pathlib import Path; from benchmark import harness; "
            "r = harness.run(Path('.'), 'tiny-new', 3, 0.3, False, time.monotonic(), 'cpu'); "
            "print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=f"{tiny_root}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny_root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["calls_done"]["value"] > 0
