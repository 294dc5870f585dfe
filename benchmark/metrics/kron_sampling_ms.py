"""Device milliseconds per interval call in the kron sampler: the work
inside the spans around `kron_core.kron_simulate`, which the kron
bootstrap calls once per chunk (the probabilities' forward chain and the
binary-split draws)."""

SPAN = "kron_core.kron_simulate"
SPANS = {SPAN: "quantpy_tpu_torch.tomography.kron_core.kron_simulate"}


def read(trace, run):
    seconds = trace.span_seconds(SPAN)
    if not seconds or not run.calls:
        return None
    return 1e3 * seconds / run.calls
