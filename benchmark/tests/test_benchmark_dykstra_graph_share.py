"""The reader of `dykstra_graph_share.qpt`: on a CPU traced run of the
throwaway process cell it reads 0 (the CPU steps eagerly) and is absent
from the other cells; on a synthetic span buffer it gives the replayed
share of the `qt.dykstra` spans' steps; and with a program whose spans
carry no `graph`, as before the graph, or that records no spans at all, it
finds nothing to read."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans
from benchmark.metrics import dykstra_graph_share

from .conftest import TINY_CELLS
from .test_benchmark_program_spans import SEED, make_span, metrics_of, one_card_call


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_dykstra_graph_share_on_a_traced_cpu_run(tiny_root, cell):
    result = harness.run(tiny_root, cell, SEED, 0.5, True, time.monotonic(), device_type="cpu")
    assert result["correct"] is True, result["checks"]
    got = metrics_of(result)
    if cell == "tiny-process":
        assert got["dykstra_graph_share"] == 0.0  # the CPU steps eagerly
    else:
        assert "dykstra_graph_share" not in got  # no process projection there


@pytest.mark.parametrize("runs, share", [
    ([(40, 40)], 100.0),  # every step replayed
    ([(40, 39), (38, 38)], 77 / 78 * 100),  # a capture's eager first step
    ([(30, 0), (10, 10)], 25.0),
    ([(41, 0)], 0.0),  # the eager routes
])
def test_dykstra_graph_share_of_the_dykstra_spans(runs, share):
    spans, _ = one_card_call()
    spans = [s for s in spans if s.name != "qt.dykstra"]
    n = len(spans)
    for i, (iters, graph) in enumerate(runs):
        spans.append(make_span("qt.dykstra", 100 + i, 1, 1, 7, 2 + i, 2.5 + i, "cuda:0",
                               iters=iters, graph=graph, host_sync=iters))
    run = SimpleNamespace(calls=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(program_spans, "recorded", lambda: spans)
        assert dykstra_graph_share.read(None, run) == pytest.approx(share)
        # a program without the graph: its qt.dykstra spans carry no `graph`
        for s in spans[n:]:
            del s.counts["graph"]
        assert dykstra_graph_share.read(None, run) is None
        mp.setattr(program_spans, "recorded", lambda: spans[:n])
        assert dykstra_graph_share.read(None, run) is None


def test_dykstra_graph_share_of_a_program_without_spans(monkeypatch):
    _, trace = one_card_call()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert dykstra_graph_share.read(trace, SimpleNamespace(calls=3)) is None
