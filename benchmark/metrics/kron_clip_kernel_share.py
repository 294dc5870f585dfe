"""The share of the kron path's eigenvalue clips that ran in the clip
kernel: 100 x `clip_kernel` / `eigh` over the program's `qt.kron.lin.clip`
spans (`eigh` counts the states clipped, `clip_kernel` those that
`make_feasible_bloch` sent to `kernels.psd_clip`; a program with the kernel
route puts the `clip_kernel` key on every such span, 0 where every state
went to `torch.linalg.eigh`). None where the program records no such span,
or none of them carries the key."""

from benchmark import program_spans

SPANS = {}
NAMES = {"qt.kron.lin.clip"}


def read(trace, run):
    spans = program_spans.recorded()
    clipped = program_spans.per_call(spans, "eigh", run.calls, NAMES)
    if not clipped or not any(s.name in NAMES and "clip_kernel" in s.counts for s in spans):
        return None
    return 100.0 * program_spans.per_call(spans, "clip_kernel", run.calls, NAMES) / clipped
