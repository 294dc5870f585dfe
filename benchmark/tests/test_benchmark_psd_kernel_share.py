"""The reader of `psd_kernel_share.qpt`: on a CPU traced run of the
throwaway process cell it reads 0 (the CPU projects by eigh) and is absent
from the other cells; on a synthetic span buffer it gives the kernel's
share of the `qt.psd` spans; and with a program that records no `qt.psd`
span, as before the kernel, or no spans at all, it finds nothing to read."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans
from benchmark.metrics import psd_kernel_share

from .conftest import TINY_CELLS
from .test_benchmark_program_spans import SEED, make_span, metrics_of, one_card_call


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_psd_kernel_share_on_a_traced_cpu_run(tiny_root, cell):
    result = harness.run(tiny_root, cell, SEED, 0.5, True, time.monotonic(), device_type="cpu")
    assert result["correct"] is True, result["checks"]
    got = metrics_of(result)
    if cell == "tiny-process":
        assert got["psd_kernel_share"] == 0.0  # the CPU projects by eigh
    else:
        assert "psd_kernel_share" not in got  # no process projection there


@pytest.mark.parametrize("launches, eigh, share", [(40, 0, 100.0), (30, 10, 75.0), (0, 41, 0.0)])
def test_psd_kernel_share_of_the_psd_spans(launches, eigh, share):
    spans, _ = one_card_call()
    n = len(spans)
    # one qt.psd span per Dykstra step inside qt.dykstra, split between the routes
    for i in range(launches + eigh):
        counts = {"launches": 1} if i < launches else {"eigh": 1, "host_sync": 1}
        spans.append(make_span("qt.psd", 100 + i, 5, 1, 7, 2 + i * 1e-3, 2.0005 + i * 1e-3,
                               "cuda:0", **counts))
    run = SimpleNamespace(calls=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(program_spans, "recorded", lambda: spans)
        assert psd_kernel_share.read(None, run) == pytest.approx(share)
        # a program without the kernel records no qt.psd span
        mp.setattr(program_spans, "recorded", lambda: spans[:n])
        assert psd_kernel_share.read(None, run) is None


def test_psd_kernel_share_of_a_program_without_spans(monkeypatch):
    _, trace = one_card_call()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert psd_kernel_share.read(trace, SimpleNamespace(calls=3)) is None
