"""Device milliseconds per interval call in the kron path's RrhoR loops:
the work inside the spans around `kron_core.kron_estimate_mle_rhor` less
that inside the spans around `kron_core.kron_estimate_lin`, which it calls
for its starts and whose device ranges lie inside its own."""

from benchmark.metrics import kron_lin_ms

SPAN = "kron_core.kron_estimate_mle_rhor"
SPANS = {SPAN: "quantpy_tpu_torch.tomography.kron_core.kron_estimate_mle_rhor",
         **kron_lin_ms.SPANS}


def seconds(trace):
    """Device seconds of the window's RrhoR loops, starts left out; None
    where the trace has none."""
    total = trace.span_seconds(SPAN)
    if not total:
        return None
    return total - (trace.span_seconds(kron_lin_ms.SPAN) or 0.0)


def read(trace, run):
    s = seconds(trace)
    if not s or not run.calls:
        return None
    return 1e3 * s / run.calls
