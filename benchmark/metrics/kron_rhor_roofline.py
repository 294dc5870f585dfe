"""Per cent of its roofline that the kron path's RrhoR work reaches: the
least time the card could take for the window's RrhoR resample-iterations
(`iters` x `resamples` on each of the program's `qt.kron.rhor` spans),
counted from the problem (`benchmark/kron_roofline.py`), over the device
time of the loops (`kron_rhor_ms`). None where the program records no
`qt.kron.rhor` span."""

from benchmark import kron_roofline, program_spans, roofline
from benchmark.metrics import kron_rhor_ms

SPANS = dict(kron_rhor_ms.SPANS)


def read(trace, run):
    spans = program_spans.recorded()
    seconds = kron_rhor_ms.seconds(trace)
    if spans is None or not seconds:
        return None
    loops = [s for s in spans if s.name == "qt.kron.rhor"]
    if not loops:
        return None
    n = run.config["n_qubits"]
    c = kron_roofline.outcomes_per_qubit(run.config)
    work = sum(s.counts.get("iters", 0) * s.counts.get("resamples", 0) for s in loops)
    resamples = sum(s.counts.get("resamples", 0) for s in loops)
    flop = kron_roofline.flops_per_resample_iteration(n, c) * work
    nbytes = kron_roofline.rhor_bytes(n, c, resamples)
    return 100.0 * roofline.least_seconds(flop, nbytes) / seconds
