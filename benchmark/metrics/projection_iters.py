"""Dykstra iterations per process-interval call: the steps the CPTP
projection of the resamples ran (`iters` on the program's `qt.dykstra`
spans). The data sets them: each call runs until its resamples' largest
criterion is under the tolerance."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.per_call(program_spans.recorded(), "iters", run.calls, {"qt.dykstra"})
