"""Milliseconds per call in which the card idles while the interval or
mesh layer itself holds it: the card's idle time, from the gaps in its
work, where the innermost open program span on the thread driving the card
is the call's root (`qt.interval`, `qt.mesh.call`) or one of its host
stages (inputs, readback, sort; set-up, gather), the mean over the cards.
The part of `host_ms_per_call` that no lower layer holds."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.interval_idle_ms(trace, program_spans.recorded(), run.calls)
