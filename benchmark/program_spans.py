"""The program's own spans and counters (`quantpy_tpu_torch.utils.profiling`),
read beside the reduced trace in the traced run.

The program records its spans while the traced run's profiler records, on
the profiler's clock (`time.time_ns()`), each with its thread, the device
it drives where known, its parent and root (the call) and its counts. A
program without them (an older checkout) gives None here, and every
reader of this module then finds nothing to read.
"""

from __future__ import annotations

import numpy as np

from benchmark.trace import merge

#: the spans of one call's root, the outermost layer of each kind of cell
ROOTS = ("qt.interval", "qt.mesh.call")
#: the interval and mesh layers' own spans: the roots and their host stages
OWN = ROOTS + ("qt.interval.inputs", "qt.interval.readback", "qt.interval.sort",
               "qt.mesh.setup", "qt.mesh.gather")
SHARD = "qt.mesh.shard"


def recorded():
    """The spans of the traced window, or None where the program records
    none."""
    try:
        from quantpy_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    return None if read is None else read()


def seconds(s) -> tuple:
    """A span's host extent in seconds, on the trace's clock."""
    return s.start_ns * 1e-9, s.end_ns * 1e-9


def card(s, default: int = 0) -> int:
    """The index of the card a span drives (`default` where not known)."""
    d = s.device
    return d.index if d is not None and d.type == "cuda" and d.index is not None else default


def per_call(spans, counter: str, calls: int, names=None):
    """The sum of `counter` over the spans (named in `names`) per call;
    None where no call or no such span was recorded."""
    if spans is None or not calls or not any(s.name in ROOTS for s in spans):
        return None
    chosen = [s for s in spans if names is None or s.name in names]
    if not chosen:
        return None
    return sum(s.counts.get(counter, 0) for s in chosen) / calls


def union(rows) -> np.ndarray:
    """Sorted, disjoint (start, end) rows covering the (start, end) rows."""
    return merge(np.asarray(rows, dtype=np.float64).reshape(-1, 2))


def subtract(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The parts of the disjoint sorted rows `a` outside those of `b`."""
    out = []
    for lo, hi in a:
        for blo, bhi in b:
            if bhi <= lo or blo >= hi:
                continue
            if blo > lo:
                out.append((lo, blo))
            lo = max(lo, bhi)
            if lo >= hi:
                break
        if lo < hi:
            out.append((lo, hi))
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def self_times(spans) -> dict:
    """For each span id, the parts of its host extent in which it is the
    innermost open span on its thread: its extent less its children's on
    the same thread."""
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        inner = union([seconds(c) for c in children.get(s.id, []) if c.thread == s.thread])
        out[s.id] = subtract(union([seconds(s)]), inner)
    return out


def idle_in(busy, intervals) -> float:
    """Seconds in which the card was idle inside the disjoint rows."""
    return float(sum((hi - lo) - busy.within(lo, hi) for lo, hi in intervals))


def own_idle_s(trace, spans, dev: int) -> float:
    """Seconds card `dev` idled while the thread driving it was inside the
    interval or mesh layer's own spans, innermost: the caller's thread,
    but for card `dev`'s shards, when the shard's worker thread drives it."""
    selfs = self_times(spans)
    own = union(np.concatenate([selfs[s.id] for s in spans if s.name in OWN] or [np.zeros((0, 2))]))
    shards = union([seconds(s) for s in spans if s.name == SHARD and card(s) == dev])
    return idle_in(trace.busy[dev], subtract(own, shards))


def interval_idle_ms(trace, spans, calls: int):
    """Milliseconds per call in which the card idled while the interval or
    mesh layer itself held it (`own_idle_s`), the mean over the cards;
    None where the trace has no device work or the program no spans."""
    if trace is None or not trace.busy or spans is None or not calls:
        return None
    if not any(s.name in ROOTS for s in spans):
        return None
    cards = sorted(trace.busy)
    return 1e3 * sum(own_idle_s(trace, spans, d) for d in cards) / len(cards) / calls


def span_idle_ms(trace, spans, name: str, calls: int):
    """Milliseconds per call in which the card a span drives idled during
    the host extents of the spans `name`."""
    if trace is None or not trace.busy or spans is None or not calls:
        return None
    chosen = [s for s in spans if s.name == name]
    if not chosen:
        return None
    idle = 0.0
    for s in chosen:
        dev = card(s)
        if dev in trace.busy:
            idle += idle_in(trace.busy[dev], union([seconds(s)]))
    return 1e3 * idle / calls


def shard_skew_ms(trace, spans):
    """Milliseconds per call between the first and the last card to end
    its `qt.mesh.shard` work: the device ranges of the shard spans,
    grouped by the call whose root started last before each range, and
    per card its latest end."""
    if trace is None or spans is None or SHARD not in trace.ranges:
        return None
    starts = np.sort([s.start_ns * 1e-9 for s in spans if s.name in ROOTS and s.parent is None])
    if len(starts) == 0:
        return None
    ends: dict = {}
    for dev, lo, hi in trace.ranges[SHARD]:
        call = int(np.searchsorted(starts, lo, side="right")) - 1
        if call >= 0:
            per_card = ends.setdefault(call, {})
            per_card[dev] = max(per_card.get(dev, hi), hi)
    skews = [max(e.values()) - min(e.values()) for e in ends.values() if len(e) > 1]
    return 1e3 * float(np.mean(skews)) if skews else None
