"""Per cent of the traced window in which no work ran on the card: one
minus the union of its kernels, copies and sets over the window, the mean
over the cards the cell uses."""

from benchmark.trace import idle_share

SPANS = {}


def read(trace, run):
    share = idle_share(trace.busy_s, trace.window_s)
    return None if share is None else 100.0 * share
