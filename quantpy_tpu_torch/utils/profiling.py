"""Lightweight observability: stage timers and torch.profiler traces (port
of quantpy_tpu/utils/profiling.py).

- `StageTimer`: named wall-clock stages that synchronize the device before
  and after each stage, so timings measure completed device work, not
  dispatch;
- `trace()`: a context manager around torch.profiler that writes a Chrome
  trace (TensorBoard- and Perfetto-readable) into a directory;
- `log`: a structured stderr logger.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

from ..config import get_device

__all__ = ["StageTimer", "trace", "log"]


def log(event: str, **fields) -> None:
    """One-line structured JSON log to stderr."""
    print(json.dumps({"event": event, **fields}), file=sys.stderr, flush=True)


class StageTimer:
    """Accumulate named stage timings with optional device sync.

    The device synchronized is `device` (default: `config.get_device()`):
    on ``cuda`` every stage waits for the card's queue to drain, on the CPU
    there is nothing to wait for. A ``cuda`` timer on a host without CUDA
    raises where PyTorch does.

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

    The host's operators are always recorded; on a ``cuda`` device
    (default: `config.get_device()`) the card's kernels and copies too.
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
