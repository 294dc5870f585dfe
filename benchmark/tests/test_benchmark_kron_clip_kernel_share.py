"""The reader of `kron_clip_kernel_share`: on a traced CPU run of the
throwaway kron cell it reads 0 (the CPU clips every state by eigh); on
synthetic spans it gives the kernel's share of the `qt.kron.lin.clip`
spans' clipped states, 0 where they carry `clip_kernel` 0; where no span
carries the key, as in a program without the clip kernel, or no spans
were recorded, it finds nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import program_spans
from benchmark.metrics import kron_clip_kernel_share

from .test_benchmark_kron import kron_root, run  # noqa: F401
from .test_benchmark_program_spans import make_span


def test_kron_clip_kernel_share_on_a_traced_cpu_run(kron_root):  # noqa: F811
    result = run(kron_root, trace=True)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["kron_clip_kernel_share"]["value"] == 0.0


def clip_spans(**counts):
    # one call, its chunks' lin starts clipped in two spans
    return [
        make_span("qt.interval", 1, None, 1, 7, 0, 10, "cuda:0"),
        make_span("qt.kron.bootstrap", 2, 1, 1, 7, 0.2, 9.5, "cuda:0", chunks=2, resamples=38),
        make_span("qt.kron.lin.clip", 3, 2, 1, 7, 1.0, 1.5, "cuda:0", **counts),
        make_span("qt.kron.lin.clip", 4, 2, 1, 7, 5.0, 5.5, "cuda:0", **counts),
    ]


@pytest.mark.parametrize("counts, share", [
    ({"eigh": 19, "clip_kernel": 19, "launches": 1}, 100.0),
    ({"eigh": 19, "clip_kernel": 0, "host_sync": 1}, 0.0),
])
def test_kron_clip_kernel_share_of_the_clip_spans(monkeypatch, counts, share):
    monkeypatch.setattr(program_spans, "recorded", lambda: clip_spans(**counts))
    assert kron_clip_kernel_share.read(None, SimpleNamespace(calls=1)) == pytest.approx(share)


def test_kron_clip_kernel_share_finds_nothing_without_the_kernel_or_spans(monkeypatch):
    run_info = SimpleNamespace(calls=1)
    monkeypatch.setattr(program_spans, "recorded", lambda: clip_spans(eigh=19, host_sync=1))
    assert kron_clip_kernel_share.read(None, run_info) is None
    spans = [s for s in clip_spans(eigh=19) if s.name != "qt.kron.lin.clip"]
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    assert kron_clip_kernel_share.read(None, run_info) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert kron_clip_kernel_share.read(None, run_info) is None
