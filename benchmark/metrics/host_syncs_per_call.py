"""Points per interval call at which the host waits for the card, as the
program counts them (`host_sync` on its spans): reads of a tensor's value,
uploads from host memory, and the error checks of `torch.linalg` calls on
the card."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.per_call(program_spans.recorded(), "host_sync", run.calls)
