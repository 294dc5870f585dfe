"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, loading (and in a fresh checkout building) the kernel
libraries, the experiment, the point estimate and the warm calls."""

SPANS = {}


def read(trace, run):
    return run.setup_s
