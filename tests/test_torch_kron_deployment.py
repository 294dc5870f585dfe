"""The 8-qubit W-state deployment's path (the kron-factored design) held to
the plain float64 reference `benchmark/reference/kron_state.py`, which
contracts one qubit at a time, at 6 qubits: W(6), the first size a proj-set
tomograph runs in kron mode. Also the kron path's spans and counters under
a CPU profiler, and its outputs unchanged by the profiler.
"""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import quantpy_tpu_torch as qt
from benchmark.reference import kron_state as ref
from quantpy_tpu_torch.measurements import _single_qubit_preset
from quantpy_tpu_torch.tomography import kron_core
from quantpy_tpu_torch.utils import profiling

from ._torch_cpu import on_cpu  # noqa: F401

N = 6
F64 = torch.float64
REPO = Path(__file__).resolve().parents[1]
POVM1 = _single_qubit_preset("proj-set")
KETS = {"w": ref.w_ket, "ghz": ref.ghz_ket}
#: the limits of the deployment's cell (`correct` on the card)
LIMITS = json.loads((REPO / "benchmark" / "cells" / "w8-rhor256.json").read_text())["limits"]


def bloch_of(state: str) -> torch.Tensor:
    return torch.as_tensor(ref.bloch_of_ket(KETS[state](N)))


def drawn(state: str, batch: int, seed: int, shots: int = 100) -> torch.Tensor:
    """(batch, 3^N, 2^N) counts drawn with NumPy from the state's
    probabilities."""
    p = ref.probabilities(bloch_of(state), N).numpy()
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack([ref.draw_counts(rng, p, shots) for _ in range(batch)]))


def w_tomograph(dtype, key=5):
    tmg = qt.StateTomograph(qt.Qobj(ref.w_ket(N), is_ket=True), key=key, dtype=dtype)
    tmg.experiment(100, "proj-set")
    assert tmg.kron_mode and tmg.povm_matrix is None
    assert tmg.results.shape == (3**N, 2**N)
    tmg.point_estimate("mle-rhor", max_iter=10)
    return tmg


@pytest.mark.parametrize("state", sorted(KETS))
def test_probabilities(state):
    b = bloch_of(state)
    assert np.abs(qt.Qobj(KETS[state](N), is_ket=True).bloch - b.numpy()).max() == 0.0
    got = kron_core.kron_probs(torch.as_tensor(POVM1, dtype=F64), N, b)
    assert (got - ref.probabilities(b, N)).abs().max() <= 1e-12


@pytest.mark.parametrize("physical", [False, True])
def test_lin(physical):
    counts = drawn("w", 3, 11)
    got = kron_core.kron_estimate_lin(counts, torch.as_tensor(POVM1, dtype=F64), N, physical)
    assert (got - ref.lin(ref.frequencies(counts), N, physical)).abs().max() <= 1e-10


@pytest.mark.parametrize("batch", [1, 3])
def test_rhor_fixed_iterations(batch):
    counts = drawn("w", batch, 13)
    got = kron_core.kron_estimate_mle_rhor(counts, torch.as_tensor(POVM1, dtype=F64), N,
                                           max_iter=10, tol=0.0)
    f = ref.frequencies(counts)
    assert (got - ref.rhor(f, ref.lin(f, N), N, 10)).abs().max() <= 1e-9


def interval_with_counts(tmg, monkeypatch, **options):
    """The interval's sorted distances, and the counts its sampler drew."""
    seen = []
    original = kron_core.kron_simulate

    def keep(*args, **kwargs):
        seen.append(original(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(kron_core, "kron_simulate", keep)
    iv = qt.BootstrapStateInterval(tmg, key=7, **options)
    iv.setup()
    return iv.distances, torch.cat(seen)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interval_distances_match_the_reference(dtype, monkeypatch):
    tmg = w_tomograph(dtype)
    dist, counts = interval_with_counts(tmg, monkeypatch, n_points=8, method="mle-rhor",
                                        max_iter=5)
    assert counts.shape == (8, 3**N, 2**N) and len(dist) == 8
    center = torch.as_tensor(tmg.reconstructed_state.bloch, dtype=F64)
    f = ref.frequencies(counts.to(F64))
    est = ref.rhor(f, ref.lin(f, N), N, 5)
    want = np.sort(ref.hs_distance(est, center, N).numpy())
    gap = np.abs(np.asarray(dist) - want).max()
    if dtype == torch.float64:
        assert gap <= 1e-9
    else:
        assert gap / np.median(want) <= LIMITS["dist_gap"]


def kron_spans(tmg, **options):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        iv = qt.BootstrapStateInterval(tmg, key=9, **options)
        iv.setup()
    return iv.distances, profiling.recorded()


@pytest.mark.parametrize("per_chunk", [3, 8])
def test_spans_and_counters(per_chunk, monkeypatch):
    monkeypatch.setattr(kron_core, "CHUNK_COUNT_ENTRIES", per_chunk * 6**N)
    tmg = w_tomograph(torch.float64)
    _, spans = kron_spans(tmg, n_points=8, method="mle-rhor", max_iter=5)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    chunks = math.ceil(8 / per_chunk)
    (boot,) = by_name["qt.kron.bootstrap"]
    assert boot.counts == {"chunks": chunks, "resamples": 8}
    loops = by_name["qt.kron.rhor"]
    assert len(loops) == len(by_name["qt.kron.sample"]) == chunks
    assert all(1 <= s.counts["iters"] <= 5 for s in loops)
    assert sum(s.counts["resamples"] for s in loops) == 8
    # one read of the largest change per step
    assert all(s.counts["host_sync"] == s.counts["iters"] for s in loops)
    assert sum(s.counts["eigh"] for s in by_name["qt.kron.lin.clip"]) == 8
    assert len(by_name["qt.kron.lin.solve"]) == chunks
    ids = {s.id: s for s in spans}
    for s in loops + by_name["qt.kron.sample"]:
        assert ids[s.parent].name == "qt.kron.bootstrap"
    assert ids[boot.parent].name == "qt.interval"


@pytest.mark.parametrize("method", ["lin", "mle-rhor"])
def test_outputs_unchanged_by_the_profiler(method):
    tmg = w_tomograph(torch.float32)
    quiet = qt.BootstrapStateInterval(tmg, key=9, n_points=8, method=method, max_iter=5)
    quiet.setup()
    traced, spans = kron_spans(tmg, n_points=8, method=method, max_iter=5)
    assert any(s.name == "qt.kron.bootstrap" for s in spans)
    assert np.array_equal(quiet.distances, traced)


@pytest.mark.parametrize("path", ["benchmark/reference/kron_state.py"])
def test_reference_stands_alone(path):
    """The reference imports nothing of JAX, the JAX package or the port."""
    text = (REPO / path).read_text()
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        assert {n.split(".", 1)[0] for n in names} <= {"__future__", "numpy", "torch"}, path
