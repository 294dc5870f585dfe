"""Chunks per interval call of the kron bootstrap (`chunks` on the
program's `qt.kron.bootstrap` spans): the resamples are drawn and
estimated in chunks of at most `kron_core.CHUNK_COUNT_ENTRIES` outcome
counts, each with its own draw, lin starts and RrhoR loop."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.per_call(program_spans.recorded(), "chunks", run.calls,
                                  {"qt.kron.bootstrap"})
