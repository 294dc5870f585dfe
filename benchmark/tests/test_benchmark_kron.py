"""The kron cell's pieces on the CPU: a throwaway `tiny-kron` cell (W(6) in
kron mode, 8 resamples of RrhoR-5, new files and BENCHMARK.json entries in
a temporary copy, as `conftest.make_tiny_root` builds its cells) runs
correct traced and untraced; the kron sampler's faults make it not
correct; the new readers on synthetic `qt.kron.*` spans, and None without
them; and the kron roofline's work against a hand count."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, kron_faults, kron_roofline, program_spans
from benchmark.metrics import (kron_chunks_per_call, kron_lin_ms, kron_rhor_idle_ms,
                               kron_rhor_ms, kron_rhor_roofline, kron_sampling_ms)
from quantpy_tpu_torch.measurements import _single_qubit_preset
from quantpy_tpu_torch.tomography import kron_core

from .conftest import dump, load, make_tiny_root
from .test_benchmark_program_spans import make_span, summary

SEED = 2**31 + 29
CELL = "tiny-kron"
#: W(6) is the first size in kron mode; 100 shots (the configuration's)
#: keep outcomes expected 25 times over a call's 8 resamples, which the
#: moments need (at 10 shots W(6)'s likeliest outcome, p = 1/6, gives 13)
TINY = {"n_qubits": 6, "n_povms": 729, "n_outcomes": 64}


@pytest.fixture
def kron_root(tmp_path):
    root = make_tiny_root(tmp_path)
    base = root / "benchmark"
    cfg = load(base / "configs" / "w8-projset.json")
    cfg.update(TINY, name="tiny-w6")
    dump(cfg, base / "configs" / "tiny-w6.json")
    t = load(base / "traffic" / "rhor256.json")
    t["options"] = {"n_points": 8, "method": "mle-rhor", "max_iter": 5}
    t["center"]["max_iter"] = 10
    dump(t, base / "traffic" / f"{CELL}.json")
    dump({"checked_calls": 1, "limits": load(base / "cells" / "w8-rhor256.json")["limits"]},
         base / "cells" / f"{CELL}.json")
    manifest = load(root / "BENCHMARK.json")
    manifest["workloads"].append({"name": CELL, "config": "tiny-w6", "traffic": CELL,
                                  "chips": 1, "why": "a CPU test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "w8-rhor256" in m.get("workloads", []):
            m["workloads"].append(CELL)
    dump(manifest, root / "BENCHMARK.json")
    return root


def run(root, trace=False, seconds=0.3):
    return harness.run(root, CELL, SEED, seconds, trace, time.monotonic(), device_type="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_kron_runs_correct(kron_root, trace):
    result = run(kron_root, trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    got = result["metrics"]
    if not trace:
        assert {"resamples_per_s.lin", "setup_s"} <= set(got)
        return
    # the CPU trace has no device work: only the program's counter reads
    assert got["kron_chunks_per_call"]["value"] == 1.0
    assert not {"kron_sampling_ms", "kron_lin_ms", "kron_rhor_ms", "kron_rhor_roofline",
                "kron_rhor_idle_ms"} & set(got)


def test_tiny_kron_chunks_follow_the_chunk_rule(kron_root, monkeypatch):
    # three resamples' counts a chunk: 8 resamples in chunks of 3, 3 and 2
    monkeypatch.setattr(kron_core, "CHUNK_COUNT_ENTRIES", 3 * 6**6)
    result = run(kron_root, True)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["kron_chunks_per_call"]["value"] == 3.0


@pytest.mark.parametrize("fault", sorted(kron_faults.SAMPLER_FAULTS))
def test_kron_sampler_fault_is_not_correct(kron_root, monkeypatch, fault):
    monkeypatch.setattr(kron_core, "kron_simulate",
                        kron_faults.SAMPLER_FAULTS[fault](kron_core.kron_simulate))
    result = run(kron_root)
    assert result["correct"] is False, result["checks"]


def kron_call():
    """One call on one card: two chunks, each a draw, a lin start and an
    RrhoR loop of 10 steps; the card busy in [1, 2], [3, 5] and [6, 9] s."""
    spans = [
        make_span("qt.kron.sample", 3, 2, 1, 7, 0.5, 1),
        make_span("qt.kron.rhor", 4, 2, 1, 7, 2, 5, "cuda:0", iters=10, resamples=19,
                  host_sync=10),
        make_span("qt.kron.rhor", 5, 2, 1, 7, 5, 8, "cuda:0", iters=10, resamples=19,
                  host_sync=10),
        make_span("qt.kron.bootstrap", 2, 1, 1, 7, 0.2, 9.5, "cuda:0", chunks=2, resamples=38),
        make_span("qt.interval", 1, None, 1, 7, 0, 10, "cuda:0"),
    ]
    ranges = {kron_sampling_ms.SPAN: [(0, 1, 2)],
              kron_rhor_ms.SPAN: [(0, 3, 5), (0, 6, 9)],
              kron_lin_ms.SPAN: [(0, 3, 3.5), (0, 6, 6.5)]}
    return spans, summary({0: [(1, 2), (3, 5), (6, 9)]}, ranges)


def test_readers_on_synthetic_kron_spans(monkeypatch):
    spans, trace = kron_call()
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    config = {"n_qubits": 8, "n_povms": 6561, "n_outcomes": 256}
    run_info = SimpleNamespace(calls=2, config=config)
    assert kron_sampling_ms.read(trace, run_info) == pytest.approx(500.0)
    assert kron_lin_ms.read(trace, run_info) == pytest.approx(500.0)
    # the loops' 5 s of work less the starts' 1 s, over 2 calls
    assert kron_rhor_ms.read(trace, run_info) == pytest.approx(2000.0)
    assert kron_chunks_per_call.read(trace, run_info) == 1.0
    # the card idles in [2, 3] and [5, 6] of the loops' extents [2, 8]
    assert kron_rhor_idle_ms.read(trace, run_info) == pytest.approx(1000.0, abs=1e-3)
    flop = 278_802_432 * (10 * 19 + 10 * 19)
    nbytes = 4 * 38 * (6**8 + 2 * 4**8)
    least = max(flop / 67e12, nbytes / 3.35e12)
    assert kron_rhor_roofline.read(trace, run_info) == pytest.approx(100 * least / 4.0)


def test_readers_find_nothing_without_kron_spans(monkeypatch):
    spans, trace = kron_call()
    config = {"n_qubits": 8, "n_povms": 6561, "n_outcomes": 256}
    run_info = SimpleNamespace(calls=2, config=config)
    others = [s for s in spans if not s.name.startswith("qt.kron")]
    monkeypatch.setattr(program_spans, "recorded", lambda: others)
    for reader in (kron_rhor_idle_ms, kron_chunks_per_call, kron_rhor_roofline):
        assert reader.read(trace, run_info) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    empty = summary({0: [(1, 2)]})
    for reader in (kron_sampling_ms, kron_lin_ms, kron_rhor_ms, kron_rhor_idle_ms,
                   kron_chunks_per_call, kron_rhor_roofline):
        assert reader.read(empty, run_info) is None


def test_kron_roofline_work_by_hand():
    # forward 38,737,920 + adjoint 38,737,920 + R rho R 12 x 256^3
    assert kron_roofline.flops_per_resample_iteration(8, 6) == 278_802_432
    assert kron_roofline.flops_per_resample_iteration(8, 6) == 2 * 38_737_920 + 12 * 256**3
    assert kron_roofline.rhor_bytes(8, 6, 19) == 4 * 19 * (1_679_616 + 2 * 65_536)
    assert kron_roofline.outcomes_per_qubit(
        {"n_qubits": 8, "n_povms": 6561, "n_outcomes": 256}) == 6
    with pytest.raises(ValueError):
        kron_roofline.outcomes_per_qubit({"n_qubits": 2, "n_povms": 10, "n_outcomes": 4})


def test_kron_faults_keep_the_shots():
    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=torch.float64)
    bloch = torch.zeros(3, 16, dtype=torch.float64)
    bloch[:, 0] = 0.25
    gen = torch.Generator().manual_seed(3)
    for fault in kron_faults.SAMPLER_FAULTS.values():
        counts = fault(kron_core.kron_simulate)(gen, povm1, bloch, 10.0)
        assert counts.shape == (3, 9, 4)
        assert torch.equal(counts.sum(-1), torch.full((3, 9), 10.0, dtype=torch.float64))
