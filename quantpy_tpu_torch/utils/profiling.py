"""Lightweight observability: spans and counters, stage timers and
torch.profiler traces (port of quantpy_tpu/utils/profiling.py).

- `span(name, device=None, device_range=False)`: a context manager around
  one layer's work; `count(name, n=1)` adds to the innermost open span's
  counts. They record exactly while a `torch.profiler` session records
  (the flag torch sets for its own Python-side checks): `trace()`, the
  benchmark's traced run or any `torch.profiler.profile` turns them on, and
  nothing else does. Off, each site reads that flag and returns a shared
  no-op. On, a span opens a profiler range of its name on the host, so it
  lands in the Chrome trace and the profiler's event list, and on closing
  appends its record to an in-memory buffer that `recorded()` reads.
  `current()` and `resumed()` hand a caller's open span to a worker thread;
- `StageTimer`: named wall-clock stages that synchronize the device before
  and after each stage, so timings measure completed device work, not
  dispatch; each stage is also a span of its name;
- `trace()`: a context manager around torch.profiler that writes a Chrome
  trace (TensorBoard- and Perfetto-readable) into a directory;
- `log`: a structured stderr logger.

The program's spans, outermost first:

- `qt.interval` (a bootstrap interval's `setup`), with `qt.interval.inputs`
  (center, generator, uploads of the design), `qt.interval.readback` (the
  distances' copy to the host) and `qt.interval.sort` (sort and
  interpolant);
- `qt.mesh.call` (a resample-sharded mesh function), with `qt.mesh.setup`
  (shard generators, replicas), `qt.mesh.shard` (one shard, in the worker
  thread of its device) and `qt.mesh.gather`;
- `qt.sample` (`state_core.simulate_experiment`); `qt.lin.solve` and
  `qt.lin.clip` (the Gram solves and the eigenvalue clip of linear
  inversion); `qt.rhor` (a launch of the RrhoR kernel); `qt.dykstra` (a
  Dykstra projection) with `qt.dykstra.read` (each read of its criterion)
  and `qt.psd` (each PSD projection of its CP half);
- on the kron-factored design (`tomography/kron_core.py`):
  `qt.kron.bootstrap` (a bootstrap over its chunks), `qt.kron.sample` (a
  draw), `qt.kron.lin.solve` and `qt.kron.lin.clip` (the grouped Gram
  inverses and the eigenvalue clip of linear inversion) and `qt.kron.rhor`
  (an RrhoR loop).

Counters: `host_sync` (each point where the host waits for the card: a
read of a tensor's value, an upload from host memory, the error check of
a `torch.linalg` call on the card), `launches` (kernel launches, on
`qt.rhor` and `qt.psd`, and on the eigenvalue clip's span where
`make_feasible_bloch` launches `kernels.psd_clip`), `eigh` (PSD
projections by `torch.linalg.eigh`, on `qt.psd`; matrices clipped, on
`qt.kron.lin.clip`), `clip_kernel` (the matrices of those that
`make_feasible_bloch` sent to `kernels.psd_clip`; on `qt.kron.lin.clip`
always, 0 where none went), `iters` (Dykstra
steps run, on `qt.dykstra`; RrhoR steps run, on `qt.kron.rhor`),
`resamples` (on `qt.kron.bootstrap`, and on `qt.kron.rhor` the states of
its batch) and `chunks` (on `qt.kron.bootstrap`).

Only a span opened with `device_range=True` (the mesh's shards) is also a
`record_function` annotation with a device-side range: the profiler gives
each kernel to the innermost such annotation alone, so a program span with
a device range would take the kernels of every annotation around it, such
as a caller's own `record_function` around a call.

A record (`Span`) holds the name, its id, its parent's and its root's ids
(the root is the call), the thread, the device it drives where known,
start and end in `time.time_ns()` (the profiler's own clock, so host spans
and the profiler's device events share one timeline) and its counts. The
buffer keeps the newest profiler session's spans, at most `MAX_SPANS`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import sys
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _torch_profiler
from torch._C._profiler import _RecordFunctionFast

from ..config import get_device

__all__ = ["StageTimer", "trace", "log", "span", "count", "recorded", "current", "resumed",
           "to_device", "Span"]

#: records kept of one profiler session; older ones are dropped first
MAX_SPANS = 1 << 18


def log(event: str, **fields) -> None:
    """One-line structured JSON log to stderr."""
    print(json.dumps({"event": event, **fields}), file=sys.stderr, flush=True)


# -- spans and counters --------------------------------------------------------

_session = 0  # profiler sessions started in this process
_ids = itertools.count(1)
_lock = threading.Lock()
_buffer = (0, deque(maxlen=MAX_SPANS))  # (session, records)


def _on_profiler_start(start=_torch_profiler._run_on_profiler_start):
    """What torch runs as each profiler session starts, counting the
    sessions: the first span of a new one empties the buffer."""
    global _session
    _session += 1
    start()


_torch_profiler._run_on_profiler_start = _on_profiler_start


class _Stack(threading.local):
    def __init__(self):
        self.spans = []


_stack = _Stack()


class _Off:
    """The shared no-op of every site while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span; see the module docstring."""

    __slots__ = ("name", "id", "parent", "root", "thread", "device", "start_ns", "end_ns",
                 "counts", "_range")

    def __init__(self, name: str, device=None, device_range: bool = False):
        self.name = name
        self.device = device
        self.counts: dict[str, int] = {}
        self.end_ns = None
        self._range = (torch.profiler.record_function(name) if device_range
                       else _RecordFunctionFast(name))

    def __enter__(self):
        global _buffer
        if _buffer[0] != _session:
            with _lock:
                if _buffer[0] != _session:
                    _buffer = (_session, deque(maxlen=MAX_SPANS))
        spans = _stack.spans
        parent = spans[-1] if spans else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        self._range.__enter__()
        spans.append(self)
        return self

    def __exit__(self, *exc):
        _stack.spans.pop()
        self._range.__exit__(*exc)
        self._range = None
        self.end_ns = time.time_ns()
        _buffer[1].append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"device={self.device}, {self.start_ns}-{self.end_ns} ns, {self.counts})")


def span(name: str, device=None, device_range: bool = False):
    """A context manager recording the block as the span `name` while a
    profiler session records (a shared no-op otherwise); `device` is the
    device the block drives, where it is known. `device_range` makes it a
    `record_function` annotation, with the device-side range of the
    kernels launched under it (see the module docstring)."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device, device_range)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of this thread's innermost open span
    (nothing while no profiler records, or outside every span)."""
    if not _torch_profiler._is_profiler_enabled:
        return
    spans = _stack.spans
    if spans:
        counts = spans[-1].counts
        counts[name] = counts.get(name, 0) + n


def current():
    """This thread's innermost open span, or None (always None while no
    profiler records): hand it to `resumed` in a worker thread."""
    if not _torch_profiler._is_profiler_enabled:
        return None
    spans = _stack.spans
    return spans[-1] if spans else None


class _Resumed:
    __slots__ = ("span",)

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        _stack.spans.append(self.span)

    def __exit__(self, *exc):
        _stack.spans.pop()
        return False


def resumed(parent):
    """A context manager under which this thread's spans are children of
    `parent`, another thread's open span from `current()` (a no-op for
    None). The parent is not recorded again."""
    return _OFF if parent is None else _Resumed(parent)


def recorded() -> list:
    """The spans closed in the newest profiler session, in closing order
    (a copy; the buffer is not drained)."""
    return list(_buffer[1])


def to_device(x, dtype, device) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)`, counting a
    `host_sync` where host data goes to a card: PyTorch waits for a copy
    from pageable host memory to finish."""
    device = torch.device(device)
    if device.type == "cuda" and not (isinstance(x, torch.Tensor) and x.is_cuda):
        count("host_sync")
    return torch.as_tensor(x, dtype=dtype, device=device)


# -- stage timer and trace -----------------------------------------------------


class StageTimer:
    """Accumulate named stage timings with optional device sync.

    The device synchronized is `device` (default: `config.get_device()`):
    on ``cuda`` every stage waits for the card's queue to drain, on the CPU
    there is nothing to wait for. A ``cuda`` timer on a host without CUDA
    raises where PyTorch does. Each stage is also a `span` of its name, so
    it shows in a profiler trace beside the program's spans.

    >>> t = StageTimer()
    >>> with t.stage("simulate"):
    ...     counts = simulate(...)
    >>> t.report()
    """

    def __init__(self, sync: bool = True, device=None):
        self.sync = sync
        self.device = torch.device(device) if device is not None else get_device()
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(name, self.device):
            if self.sync:
                self._sync()
            t0 = time.perf_counter()
            yield
            if self.sync:
                self._sync()
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def report(self) -> dict[str, float]:
        total = sum(self.stages.values()) or 1.0
        for name, dt in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            log("stage", name=name, seconds=round(dt, 4),
                share=round(dt / total, 3))
        return dict(self.stages)


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Record a torch.profiler trace of the block and write it into
    `log_dir` as a Chrome trace (``*.pt.trace.json``).

    The host's operators and the program's spans (`span`) are always
    recorded; on a ``cuda`` device (default: `config.get_device()`) the
    card's kernels and copies too. `recorded()` reads the spans afterwards.
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = torch.device(device) if device is not None else get_device()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
