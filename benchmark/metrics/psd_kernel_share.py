"""The share of the process projection's PSD projections that ran in the
Jacobi kernel: 100 x `launches` / (`launches` + `eigh`) over the program's
`qt.psd` spans (one per CP half of a Dykstra step; `eigh` counts those that
ran `torch.linalg.eigh`). None where the program records no `qt.psd` span."""

from benchmark import program_spans

SPANS = {}


def read(trace, run):
    spans = program_spans.recorded()
    launches = program_spans.per_call(spans, "launches", run.calls, {"qt.psd"})
    eigh = program_spans.per_call(spans, "eigh", run.calls, {"qt.psd"})
    if launches is None or launches + eigh == 0:
        return None
    return 100.0 * launches / (launches + eigh)
