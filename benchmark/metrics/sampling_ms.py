"""Device milliseconds per interval call in the sampler: the work inside
the spans around `state_core.simulate_experiment`, which the state
bootstrap calls and the process bootstrap reaches through
`process_core.simulate_process_experiment`."""

SPAN = "state_core.simulate_experiment"
SPANS = {SPAN: "quantpy_tpu_torch.tomography.state_core.simulate_experiment"}


def read(trace, run):
    seconds = trace.span_seconds(SPAN)
    if not seconds or not run.calls:
        return None
    return 1e3 * seconds / run.calls
