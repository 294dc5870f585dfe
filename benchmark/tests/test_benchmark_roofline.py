"""The yardstick's arithmetic against hand counts: the RrhoR work at the
flagship shape, and the reduction of a trace to busy time and span time."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import roofline, trace

FLAGSHIP = dict(n_qubits=4, n_povms=81, n_outcomes=16)


def test_flagship_work_by_hand():
    # 2 x 1296 x 256 + 6 x 16^3 multiply-adds per resample-iteration
    assert roofline.macs_per_resample_iteration(**FLAGSHIP) == 663_552 + 24_576
    flop = roofline.flops_per_resample(**FLAGSHIP, n_iter=60) * 16384
    assert flop == pytest.approx(1.353e12, rel=1e-3)
    nbytes = roofline.rhor_bytes(**FLAGSHIP, n_points=16384)
    assert nbytes == 4 * (16384 * 1296 + 2 * 16384 * 256 + 1296 * 256)
    # compute-bound: 20.193 ms at 67 TFLOP/s, against 0.036 ms of bytes
    assert roofline.least_seconds(flop, nbytes) * 1e3 == pytest.approx(20.193, abs=5e-4)
    assert nbytes / roofline.HBM_BYTES_PER_S < 1e-4


def test_mesh_reads_the_design_once_per_card():
    one = roofline.rhor_bytes(**FLAGSHIP, n_points=65536, n_designs=1)
    four = roofline.rhor_bytes(**FLAGSHIP, n_points=65536, n_designs=4)
    assert four - one == 3 * 4 * 1296 * 256


def test_busy_union_and_windows():
    busy = trace.Busy(np.array([[0.0, 1.0], [0.5, 2.0], [3.0, 4.0], [3.5, 3.7]]))
    assert busy.iv.tolist() == [[0.0, 2.0], [3.0, 4.0]]
    assert busy.total == pytest.approx(3.0)
    assert busy.within(1.0, 3.5) == pytest.approx(1.5)
    assert busy.within(2.0, 3.0) == 0.0
    assert busy.within(-1.0, 10.0) == pytest.approx(3.0)
    assert busy.gaps(0.0, 5.0).tolist() == [[2.0, 3.0], [4.0, 5.0]]


class Event:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, dev, start, end, annotation=False, device=True):
        self._name, self._dev, self._s, self._e = name, dev, start, end
        self._ann, self._device = annotation, device

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._ann

    def device_index(self):
        return self._dev


def test_summary_spans_idle_and_breakdown():
    events = [
        Event("bench.call", 0, 0.0, 1.0, annotation=True),
        Event("span.a", 0, 0.1, 0.5, annotation=True),
        Event("k1", 0, 0.1, 0.3), Event("k2", 0, 0.4, 0.5),  # inside span.a: 0.3 s
        Event("k1", 0, 0.7, 1.0),
        Event("span.a", 0, 0.0, 0.2, annotation=True, device=False),  # host side: ignored
    ]
    s = trace.Summary.of(events, window_s=2.0, labels={"bench.call", "span.a"}, n_cards=1)
    assert s.busy_s == pytest.approx(0.6)
    assert s.span_seconds("span.a") == pytest.approx(0.3)
    assert s.span_seconds("absent") is None
    assert s.range_seconds("bench.call") == [pytest.approx(0.6)]
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k1" and b["device_ops"][0][1] == pytest.approx(0.5)
    idle = dict(b["idle_gaps"])
    assert idle["span.a"] == pytest.approx(0.1) and idle["bench.call"] == pytest.approx(0.2)


def test_readers_on_a_trace():
    """The per-layer readers on a hand-made trace of two calls."""
    from benchmark import harness

    events = [
        Event("bench.call", 0, 0.0, 0.1, annotation=True),
        Event("kernels.rhor_mle", 0, 0.02, 0.08, annotation=True),
        Event("rhor", 0, 0.02, 0.08),
        Event("bench.call", 0, 0.2, 0.3, annotation=True),
        Event("kernels.rhor_mle", 0, 0.22, 0.28, annotation=True),
        Event("rhor", 0, 0.22, 0.28),
    ]
    s = trace.Summary.of(events, window_s=0.4, labels={"bench.call", "kernels.rhor_mle"},
                         n_cards=1)
    cfg = dict(n_qubits=4, n_povms=81, n_outcomes=16)
    info = harness.RunInfo(cfg, {"options": {"max_iter": 60}}, chips=1, calls=2,
                           resamples=2 * 16384, walls=[0.11, 0.13], window_s=0.4, setup_s=1.0)
    roof = harness.reader("rhor_roofline").read(s, info)
    assert roof == pytest.approx(100 * 2 * 20.193e-3 / 0.12, rel=1e-3)
    assert harness.reader("host_ms_per_call.lin").read(s, info) == pytest.approx(60.0)
    assert harness.reader("device_idle_pct").read(s, info) == pytest.approx(70.0)
    assert harness.reader("sampling_ms").read(s, info) is None
    assert harness.reader("resamples_per_s").read(None, info) == pytest.approx(2 * 16384 / 0.4)
