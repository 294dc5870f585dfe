"""Milliseconds per call in which the caller waits on the host while the
card idles: the mean host-clock time of a call less the mean of the card's
work inside each call's span."""

from benchmark.harness import CALL_SPAN

SPANS = {}


def read(trace, run):
    busy = trace.range_seconds(CALL_SPAN)
    if not busy or not run.walls:
        return None
    return 1e3 * (sum(run.walls) / len(run.walls) - sum(busy) / len(busy))
