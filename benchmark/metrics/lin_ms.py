"""Device milliseconds per interval call in linear inversion and its
eigenvalue clip: the work inside the spans around
`state_core.estimate_lin` (in an RrhoR cell, the starts)."""

SPAN = "state_core.estimate_lin"
SPANS = {SPAN: "quantpy_tpu_torch.tomography.state_core.estimate_lin"}


def read(trace, run):
    seconds = trace.span_seconds(SPAN)
    if not seconds or not run.calls:
        return None
    return 1e3 * seconds / run.calls
