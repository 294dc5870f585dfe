"""Milliseconds per mesh call between the first and the last card to
finish its shard: per call, the latest end of a card's `qt.mesh.shard`
device range less the earliest. The slowest card sets the gather."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    return program_spans.shard_skew_ms(trace, program_spans.recorded())
