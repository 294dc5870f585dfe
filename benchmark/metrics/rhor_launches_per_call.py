"""Launches of the RrhoR kernel per interval call (`launches` on the
program's `qt.rhor` spans): one per call on one card, one per card and
call on the mesh."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.per_call(program_spans.recorded(), "launches", run.calls, {"qt.rhor"})
