"""Milliseconds per interval call in which the card idles during the host
extent of the program's `qt.kron.rhor` spans: the RrhoR loops' launches
and the read of each step's largest change, which `kron_rhor_ms` (the
card's work there) does not see."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.span_idle_ms(trace, program_spans.recorded(), "qt.kron.rhor", run.calls)
