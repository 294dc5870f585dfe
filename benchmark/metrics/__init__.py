"""One reader per metric, found by the metric's name in BENCHMARK.json:
metrics/<name>.py, where a name `q.kind` is the quantity q read for one
kind of cell and q's reader serves it.

A reader defines `read(trace, run)`, which returns the metric's value or
None where it finds nothing to read; `trace` is the reduced trace
(`benchmark.trace.Summary`) in a traced run and None otherwise, `run` the
run's `harness.RunInfo`. A per-layer reader also defines `SPANS`: the
spans it reads, each label mapped to the program attribute the traced run
wraps in it.
"""
