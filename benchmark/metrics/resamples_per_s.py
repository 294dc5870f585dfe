"""Resamples of the calls completed in the window over the window's wall
time: all the work over all the time."""

SPANS = {}


def read(trace, run):
    return run.resamples / run.window_s
