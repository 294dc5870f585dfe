"""Milliseconds per process-interval call in which the card idles during
the host extent of the program's `qt.dykstra` spans: the Dykstra loop's
launches and criterion reads, which `projection_ms` (the card's work
there) does not see."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.span_idle_ms(trace, program_spans.recorded(), "qt.dykstra", run.calls)
