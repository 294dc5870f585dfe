"""Device milliseconds per interval call in the kron path's linear
inversion: the work inside the spans around `kron_core.kron_estimate_lin`,
which each chunk's RrhoR loop calls for its starts (the adjoint chain, the
grouped Gram inverses and the eigenvalue clip, one `torch.linalg.eigh` of
a 2^n x 2^n matrix per resample)."""

SPAN = "kron_core.kron_estimate_lin"
SPANS = {SPAN: "quantpy_tpu_torch.tomography.kron_core.kron_estimate_lin"}


def read(trace, run):
    seconds = trace.span_seconds(SPAN)
    if not seconds or not run.calls:
        return None
    return 1e3 * seconds / run.calls
