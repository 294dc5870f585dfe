"""Device milliseconds per process-interval call in the CPTP projection of
the resamples: the work inside the spans around
`process_core.cptp_project_bloch_host`, through which the interval runs
its Dykstra iterations on either CP engine."""

SPAN = "process_core.cptp_project_bloch_host"
SPANS = {SPAN: "quantpy_tpu_torch.tomography.process_core.cptp_project_bloch_host"}


def read(trace, run):
    seconds = trace.span_seconds(SPAN)
    if not seconds or not run.calls:
        return None
    return 1e3 * seconds / run.calls
