"""The readers of the program's own spans and counters
(`benchmark/program_spans.py`): on CPU traced runs of the throwaway cells
they return the program's counts, and None where the CPU trace has no
device work; on a synthetic trace and span buffer they divide the card's
idle time as their docstrings say; and with a program that records no
spans they find nothing to read."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, program_spans
from benchmark.trace import Summary

from .conftest import TINY_CELLS

SEED = 2**31 + 23
#: the readers of the program's spans, and the metric names they serve
COUNTS = ("host_syncs_per_call", "projection_iters", "rhor_launches_per_call")
DEVICE = ("interval_idle_ms", "projection_idle_ms", "shard_skew_ms")
T0 = 1_790_000_000 * 10**9  # an epoch-scale origin, as time.time_ns() gives


def metrics_of(result: dict) -> dict:
    return {name.split(".", 1)[0]: m["value"] for name, m in result["metrics"].items()}


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_readers_on_a_traced_cpu_run(tiny_root, cell):
    result = harness.run(tiny_root, cell, SEED, 0.5, True, time.monotonic(), device_type="cpu")
    assert result["correct"] is True, result["checks"]
    got = metrics_of(result)
    assert not set(DEVICE) & set(got)  # no device work on the CPU
    assert "rhor_launches_per_call" not in got  # the CPU runs no kernel
    syncs = got["host_syncs_per_call"]
    if cell == "tiny-lin":
        assert syncs == 1.0  # the distances' readback: no upload or linalg check on the CPU
    elif cell == "tiny-process":
        # one read of the criterion per step, and the readback
        assert got["projection_iters"] >= 1 and syncs == got["projection_iters"] + 1
    elif cell == "tiny-rhor":
        assert 1 < syncs <= 1 + 10  # the readback and the plain loop's stop reads
    else:
        assert syncs >= 4  # the stop reads of the plain loop in each of 4 shards
    if cell != "tiny-process":
        assert "projection_iters" not in got


def ns(t: float) -> int:
    return T0 + int(round(t * 1e9))


def make_span(name, id, parent, root, thread, lo, hi, device=None, **counts):
    return SimpleNamespace(name=name, id=id, parent=parent, root=root, thread=thread,
                           device=None if device is None else torch.device(device),
                           start_ns=ns(lo), end_ns=ns(hi), counts=counts)


def summary(work: dict, ranges: dict | None = None, n_cards: int = 1) -> Summary:
    """A reduced trace whose cards worked in the given (start, end) rows,
    seconds after T0."""
    base = T0 * 1e-9
    work = {d: [(base + a, base + b) for a, b in rows] for d, rows in work.items()}
    ranges = {k: [(d, base + a, base + b) for d, a, b in v] for k, v in (ranges or {}).items()}
    return Summary(work, {}, ranges, 10.0, n_cards)


def one_card_call():
    """One call on one card: the interval's own stages around the sampler
    and the solve; the card busy in [0.5, 2] and [3.5, 8.5]."""
    spans = [
        make_span("qt.interval.inputs", 2, 1, 1, 7, 0, 1),
        make_span("qt.sample", 3, 1, 1, 7, 1, 3),
        make_span("qt.lin.solve", 4, 1, 1, 7, 3, 4, host_sync=1),
        make_span("qt.dykstra", 5, 1, 1, 7, 2, 6, "cuda:0", iters=40, host_sync=41),
        make_span("qt.interval.readback", 6, 1, 1, 7, 8, 9, host_sync=1),
        make_span("qt.interval.sort", 8, 1, 1, 7, 9, 10),
        make_span("qt.interval", 1, None, 1, 7, 0, 10, "cuda:0"),
    ]
    return spans, summary({0: [(0.5, 2), (3.5, 8.5)]})


def test_interval_idle_counts_only_the_interval_layers_own_time():
    spans, trace = one_card_call()
    spans = [s for s in spans if s.name != "qt.dykstra"]
    # own: inputs [0, 1], the root alone [4, 8], readback and sort [8, 10];
    # idle there: [0, 0.5] and [8.5, 10]; the gap [2, 3.5] is the sampler's and the solve's
    assert program_spans.interval_idle_ms(trace, spans, 1) == pytest.approx(2000.0, abs=1e-3)
    assert program_spans.interval_idle_ms(trace, spans, 4) == pytest.approx(500.0, abs=1e-3)


def test_span_idle_and_counts_per_call():
    spans, trace = one_card_call()
    # the card idles in [2, 3.5] of the projection's [2, 6]
    assert program_spans.span_idle_ms(trace, spans, "qt.dykstra", 1) == pytest.approx(1500.0,
                                                                                    abs=1e-3)
    assert program_spans.per_call(spans, "iters", 2, {"qt.dykstra"}) == 20
    assert program_spans.per_call(spans, "host_sync", 1) == 43
    assert program_spans.per_call(spans, "launches", 1, {"qt.rhor"}) is None
    assert program_spans.span_idle_ms(summary({}), spans, "qt.dykstra", 1) is None


def test_mesh_cards_are_held_by_their_shards_threads():
    spans = [
        make_span("qt.mesh.setup", 2, 1, 1, 7, 0, 1),
        make_span("qt.mesh.shard", 3, 1, 1, 8, 1, 6, "cuda:0"),
        make_span("qt.mesh.shard", 4, 1, 1, 9, 1, 8, "cuda:1"),
        make_span("qt.mesh.gather", 5, 1, 1, 7, 8, 9, "cuda:0"),
        make_span("qt.mesh.call", 1, None, 1, 7, 0, 10, "cuda:0"),
        make_span("qt.mesh.call", 11, None, 11, 7, 20, 30, "cuda:0"),
    ]
    ranges = {"qt.mesh.shard": [(0, 2, 5.5), (1, 1.5, 7.9), (0, 21, 25), (1, 21, 26)]}
    trace = summary({0: [(2, 5.5), (8.2, 8.6)], 1: [(1.5, 7.9), (8.2, 8.3)]}, ranges, 2)
    # card 0 outside its shard [1, 6]: [0, 1] and [6, 10] with 0.4 s of work -> 4.6 s idle;
    # the second call, [20, 30], has no work: 10 s. Card 1 outside [1, 8]: 1 + 1.9 s, then 10 s
    expected = 1e3 * ((4.6 + 10) + (2.9 + 10)) / 2 / 2
    assert program_spans.interval_idle_ms(trace, spans, 2) == pytest.approx(expected, abs=1e-3)
    # per call, the last card's end less the first's: 7.9 - 5.5 and 26 - 25
    assert program_spans.shard_skew_ms(trace, spans) == pytest.approx(1e3 * (2.4 + 1) / 2,
                                                                       abs=1e-3)


def test_a_program_without_spans_gives_nothing(monkeypatch):
    from benchmark.metrics import (host_syncs_per_call, interval_idle_ms, projection_idle_ms,
                                   projection_iters, rhor_launches_per_call, shard_skew_ms)

    _, trace = one_card_call()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    run = SimpleNamespace(calls=3)
    for reader in (host_syncs_per_call, interval_idle_ms, projection_idle_ms, projection_iters,
                   rhor_launches_per_call, shard_skew_ms):
        assert reader.read(trace, run) is None


def test_union_and_subtract():
    a = program_spans.union([(3, 4), (0, 1), (0.5, 2)])
    assert np.array_equal(a, [[0, 2], [3, 4]])
    b = program_spans.union([(1, 3.5)])
    assert np.array_equal(program_spans.subtract(a, b), [[0, 1], [3.5, 4]])
    assert program_spans.subtract(a, np.zeros((0, 2))).tolist() == a.tolist()
