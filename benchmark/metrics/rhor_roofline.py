"""Per cent of its roofline that the RrhoR kernel reaches: the least time
the card could take for the RrhoR work of the window's calls, over the
device time inside the spans around `kernels.rhor_mle`.

The work is counted from the problem, not from the kernel: 2 x max_iter x
(2KD + 6d^3) FLOP per resample and the bytes of `roofline.rhor_bytes`,
against the published FP32 peak and HBM bandwidth."""

from benchmark import roofline

SPAN = "kernels.rhor_mle"
SPANS = {SPAN: "quantpy_tpu_torch.ops.kernels.rhor_mle"}


def read(trace, run):
    seconds = trace.span_seconds(SPAN)
    if not seconds or not run.resamples:
        return None
    c = run.config
    n, m, p = c["n_qubits"], c["n_povms"], c["n_outcomes"]
    flop = roofline.flops_per_resample(n, m, p, run.traffic["options"]["max_iter"]) * run.resamples
    nbytes = roofline.rhor_bytes(n, m, p, run.resamples, n_designs=run.chips * run.calls)
    return 100.0 * roofline.least_seconds(flop, nbytes) / seconds
