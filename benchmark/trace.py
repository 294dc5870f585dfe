"""The traced run: `torch.profiler` over the window, reduced to device
busy time, the device time under each benchmark span, and the breakdown.

The device's work is every kernel, copy and set that the profiler records
on a card. A span's device time is the part of that work inside the
span's device range: the profiler's device-side annotation of a
`record_function`, from the first to the last piece of work launched while
the span was open on the host. That ties the kernels a library launches
outside any aten operation (the RrhoR kernel, launched through ctypes) to
their span as well. All times are in seconds.
"""

from __future__ import annotations

import numpy as np
import torch

TOP = 10
BETWEEN_CALLS = "between calls"
NAME_CHARS = 120


def short_name(name: str) -> str:
    """A device operation's name without its argument list, at most
    NAME_CHARS characters: C++ kernel names carry their whole signature."""
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<[":
            depth += 1
        elif ch in ">]" and depth:
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] not in " :":
            name = name[:i]
            break
    name = name.removeprefix("void ")
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


# Frozen copy of chip_smoke.py::idle_share's arithmetic (there it is printed,
# unclamped, beside the call's wall time), with `busy` the union of the card's
# work rather than its sum, so that overlapping work is not counted twice.
def idle_share(busy: float, wall: float):
    """1 - busy / wall, unclamped; None where no work was recorded."""
    if busy <= 0:
        return None
    return 1.0 - busy / wall


def merge(intervals: np.ndarray) -> np.ndarray:
    """Sorted, disjoint (start, end) rows covering the union of the rows."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.r_[last[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], axis=1)


class Busy:
    """The union of one card's work, with the time it covers in a range."""

    def __init__(self, intervals: np.ndarray):
        self.iv = merge(intervals)
        self.cum = np.r_[0.0, np.cumsum(self.iv[:, 1] - self.iv[:, 0])]

    @property
    def total(self) -> float:
        return float(self.cum[-1])

    def within(self, lo: float, hi: float) -> float:
        """Seconds of work inside [lo, hi]."""
        i0 = int(np.searchsorted(self.iv[:, 1], lo, side="right"))
        i1 = int(np.searchsorted(self.iv[:, 0], hi, side="left"))
        if i1 <= i0:
            return 0.0
        covered = self.cum[i1] - self.cum[i0]
        covered -= max(0.0, lo - self.iv[i0, 0])
        covered -= max(0.0, self.iv[i1 - 1, 1] - hi)
        return float(max(covered, 0.0))

    def gaps(self, lo: float, hi: float) -> np.ndarray:
        """(start, end) rows of the idle time inside [lo, hi]."""
        edges = np.clip(self.iv, lo, hi)
        starts = np.r_[lo, edges[:, 1]]
        ends = np.r_[edges[:, 0], hi]
        keep = ends > starts
        return np.stack([starts[keep], ends[keep]], axis=1)


class Profile:
    """`torch.profiler` over the window, on every thread (the mesh's shards
    run in worker threads)."""

    def __init__(self, devices):
        self.devices = devices
        activities = [torch.profiler.ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in devices):
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self.prof = torch.profiler.profile(activities=activities, experimental_config=config)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def summary(self, window_s: float, labels) -> "Summary":
        return Summary.of(self.prof.profiler.kineto_results.events(), window_s,
                          set(labels), len(set(self.devices)))


class Summary:
    """The reduced trace."""

    def __init__(self, work: dict, ops: dict, ranges: dict, window_s: float, n_cards: int):
        self.busy = {dev: Busy(np.asarray(iv, dtype=np.float64).reshape(-1, 2))
                     for dev, iv in work.items()}
        self.ops = ops
        self.ranges = {label: sorted(r, key=lambda x: x[1]) for label, r in ranges.items()}
        self.window_s = window_s
        self.n_cards = n_cards

    @classmethod
    def of(cls, events, window_s: float, labels: set, n_cards: int) -> "Summary":
        work, ops, ranges = {}, {}, {}
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() * 1e-9
            dur = e.duration_ns() * 1e-9
            name = e.name()
            if e.is_user_annotation() or name in labels:
                ranges.setdefault(name, []).append((e.device_index(), start, start + dur))
                continue
            work.setdefault(e.device_index(), []).append((start, start + dur))
            ops[name] = ops.get(name, 0.0) + dur
        return cls(work, ops, ranges, window_s, n_cards)

    @property
    def busy_s(self) -> float:
        """Seconds in which work ran, averaged over the cards the cell uses."""
        return sum(b.total for b in self.busy.values()) / self.n_cards

    def span_seconds(self, label: str):
        """Device seconds of the work inside the span's device ranges, summed
        over its occurrences and cards; None where the span has none."""
        if label not in self.ranges:
            return None
        return sum(self.busy[dev].within(lo, hi) for dev, lo, hi in self.ranges[label]
                   if dev in self.busy)

    def range_seconds(self, label: str) -> list:
        """Per occurrence of the span, in order: the device seconds of work
        inside its device range."""
        return [self.busy[dev].within(lo, hi) if dev in self.busy else 0.0
                for dev, lo, hi in self.ranges.get(label, [])]

    def breakdown(self) -> dict:
        """The device operations that took most time, and the card's idle
        time inside the window summed by the benchmark span it fell in."""
        ops = {}
        for name, seconds in self.ops.items():
            ops[short_name(name)] = ops.get(short_name(name), 0.0) + seconds
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        idle = {}
        for dev, busy in self.busy.items():
            if len(busy.iv) == 0:
                continue
            gaps = busy.gaps(busy.iv[0, 0], busy.iv[-1, 1])
            labels = self._labels(dev, 0.5 * (gaps[:, 0] + gaps[:, 1]))
            for label, (lo, hi) in zip(labels, gaps):
                idle[label] = idle.get(label, 0.0) + (hi - lo) / self.n_cards
        idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in device_ops],
                "idle_gaps": [[k, v] for k, v in idle_gaps]}

    def _labels(self, dev: int, times: np.ndarray) -> list:
        """For each of the sorted `times`, the narrowest benchmark span whose
        device range on card `dev` holds it."""
        best = np.full(len(times), BETWEEN_CALLS, dtype=object)
        width = np.full(len(times), np.inf)
        for label, ranges in self.ranges.items():
            for d, lo, hi in ranges:
                if d != dev:
                    continue
                i0, i1 = np.searchsorted(times, lo, "left"), np.searchsorted(times, hi, "right")
                sel = slice(i0, i1)
                narrower = width[sel] > hi - lo
                best[sel] = np.where(narrower, label, best[sel])
                width[sel] = np.where(narrower, hi - lo, width[sel])
        return list(best)
