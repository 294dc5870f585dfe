"""The share of the process projection's Dykstra steps that ran as replays
of the step's captured CUDA graph: 100 x `graph` / `iters` over the
program's `qt.dykstra` spans (`iters` counts the steps run, `graph` those
of them replayed). None where no `qt.dykstra` span carries `graph`, as in
a program without the graph."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    spans = program_spans.recorded()
    iters = program_spans.per_call(spans, "iters", run.calls, {"qt.dykstra"})
    if not iters or not any("graph" in s.counts for s in spans if s.name == "qt.dykstra"):
        return None
    return 100.0 * program_spans.per_call(spans, "graph", run.calls, {"qt.dykstra"}) / iters
