"""One run of one cell: set-up, a measured window of interval calls by one
caller in a closed loop, the check of what the window produced, and the
result line.

Everything a cell needs is found by name: the cell's entry in
BENCHMARK.json names its configuration (configs/<config>.json) and its
traffic (traffic/<traffic>.json); the traffic names the entry kind
(entries/<entry>.py); cells/<cell>.json holds the check's sample size and
limits; each per-layer metric is read by metrics/<metric>.py. A new cell,
configuration, traffic, entry kind or metric is new files and new
BENCHMARK.json entries; nothing here changes.
"""

from __future__ import annotations

import functools
import importlib
import json
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import roofline, spans

#: top-level module names that may not be loaded by the end of the window
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "quantpy_tpu")
CALL_SPAN = "bench.call"


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class ForbiddenModules(RuntimeError):
    """The window loaded JAX or the JAX package."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def derived_seed(*words: int) -> int:
    """A 63-bit seed from the run's seed and stream words."""
    entropy = [int(w) % 2**64 for w in words]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


# streams derived from --seed
SETUP, CALL, WARM, SAMPLE = 0, 1, 2, 3


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, root: Path, workload: str) -> "Cell":
        manifest = load_json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = by_name[workload]
        base = root / "benchmark"
        e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return cls(
            name=workload,
            chips=int(w["chips"]),
            config=load_json(base / "configs" / f"{w['config']}.json"),
            traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
            check=load_json(base / "cells" / f"{workload}.json"),
            end_to_end=e2e,
            per_layer=layer,
        )


class Reservoir:
    """A uniform sample of `size` of the window's calls, drawn from the
    seed: call i is kept or not when it starts (algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(derived_seed(seed, SAMPLE))
        self.kept: dict[int, tuple] = {}  # slot -> (call index, payload)

    def slot_for(self, i: int):
        if i < self.size:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.size else None

    def keep(self, slot: int, i: int, payload) -> None:
        self.kept[slot] = (i, payload)

    def samples(self) -> list:
        return [self.kept[s] for s in sorted(self.kept, key=lambda s: self.kept[s][0])]


class Capture:
    """Keeps what the timed path returned at the entry's CAPTURE attributes
    in the calls the reservoir picks, as (thread, kind, tensor): a
    reference to the tensor; nothing is copied."""

    def __init__(self):
        self.target = None
        self.lock = threading.Lock()

    def factories(self, kinds) -> dict:
        return {kind: functools.partial(self._wrap, kind) for kind in kinds}

    def _wrap(self, kind, fn):
        def captured(*args, **kwargs):
            out = fn(*args, **kwargs)
            target = self.target
            if target is not None:
                with self.lock:
                    target.append((threading.get_ident(), kind, out))
            return out

        return captured


@dataclass
class Window:
    """The measured window's calls, timed by the host clock."""

    start: float = 0.0
    end: float = 0.0
    walls: list = field(default_factory=list)
    resamples: int = 0
    failed: int = 0
    errors: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_window(session, seconds: float, seed: int, reservoir: Reservoir, capture: Capture,
               devices, traced: bool) -> Window:
    """Calls back to back until `seconds` have passed; the last call runs
    to its end. Each call is timed from its start to its quantiles on the
    host; a call that raises counts as failed."""
    import torch

    win = Window()
    win.start = time.perf_counter()
    deadline = win.start + seconds
    i = 0
    while time.perf_counter() < deadline:
        slot = reservoir.slot_for(i)
        captured = [] if slot is not None else None
        capture.target = captured
        key = derived_seed(seed, CALL, i)
        t0 = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function(CALL_SPAN):
                    distances, quantiles = session.call(key)
            else:
                distances, quantiles = session.call(key)
        except Exception:  # a failed call is counted and the loop goes on
            win.failed += 1
            if len(win.errors) < 3:
                win.errors.append(traceback.format_exc())
            distances = None
        t1 = time.perf_counter()
        capture.target = None
        win.walls.append(t1 - t0)
        if distances is not None:
            win.resamples += len(distances)
            if slot is not None:
                reservoir.keep(slot, i, (captured, distances, quantiles))
        i += 1
    sync(devices)
    win.end = time.perf_counter()
    return win


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def reader(name: str):
    """The reader of a metric: metrics/<name>.py, where a name `q.kind` is
    the quantity q read for one kind of cell (metrics/q.py)."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.', 1)[0]}")


def readers(metrics: list) -> dict:
    return {m["name"]: reader(m["name"]) for m in metrics}


def read_metrics(metrics: list, modules: dict, summary, info) -> dict:
    """{name: {value, unit}} of every metric whose reader finds a value."""
    out = {}
    for m in metrics:
        value = modules[m["name"]].read(summary, info)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclass
class RunInfo:
    """What a per-layer metric's reader knows of the run besides the trace."""

    config: dict
    traffic: dict
    chips: int
    calls: int
    resamples: int
    walls: list
    window_s: float
    setup_s: float


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device_type: str = "cuda") -> dict:
    """One run; returns the result object, whose last key, `checks`, holds
    each number compared beside its limit.

    Raises NoDevice where the cell's cards are missing. `device_type` 'cpu'
    runs the cell on repeated CPU devices: the tests drive the harness so,
    and the command never does."""
    import torch

    marks = [time.monotonic()]  # imports done; session made; warm calls done
    cell = Cell.load(root, workload)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices; the cell needs {cell.chips}")
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    else:
        devices = [torch.device("cpu")] * cell.chips

    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    session = entry.Session(cell.config, cell.traffic, derived_seed(seed, SETUP), devices)
    sync(devices)
    marks.append(time.monotonic())
    for j in range(int(cell.traffic.get("warm_calls", 1))):
        session.call(derived_seed(seed, WARM, j))
    sync(devices)
    marks.append(time.monotonic())

    metrics = cell.per_layer if trace else cell.end_to_end
    modules = readers(metrics)
    labels = {}
    for mod in modules.values():
        labels.update(mod.SPANS)
    capture = Capture()
    reservoir = Reservoir(int(cell.check["checked_calls"]), seed)
    setup_s = time.monotonic() - t0
    with spans.wrapped({label: spans.span(label) for label in labels}, labels), \
            spans.wrapped(capture.factories(entry.CAPTURE), entry.CAPTURE):
        if trace:
            from . import trace as tracing

            seconds = min(seconds, float(cell.traffic.get("trace_seconds", seconds)))
            with tracing.Profile(devices) as prof:
                win = run_window(session, seconds, seed, reservoir, capture, devices, True)
        else:
            win = run_window(session, seconds, seed, reservoir, capture, devices, False)

    log(f"{cell.name}: set-up {setup_s:.3f} s (start and imports {marks[0] - t0:.3f}, session "
        f"{marks[1] - marks[0]:.3f}, warm calls {marks[2] - marks[1]:.3f}); window "
        f"{win.seconds:.3f} s, {len(win.walls)} calls, {win.failed} failed")
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"the window loaded {', '.join(found)}")
    for err in win.errors:
        log(err)
    if device_type == "cuda":
        for d in devices:
            log(f"{cell.name}: cuda:{d.index} is {roofline.device_label(d.index)}")
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if device_type == "cuda" else 0
    device = {"platform": "gpu" if device_type == "cuda" else device_type,
              "kind": torch.cuda.get_device_name(0) if device_type == "cuda" else device_type,
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    check_inputs = session.release()
    del session
    if device_type == "cuda":
        torch.cuda.empty_cache()

    info = RunInfo(cell.config, cell.traffic, cell.chips, len(win.walls) - win.failed,
                   win.resamples, win.walls, win.seconds, setup_s)
    result = {"correct": None, "attempted": len(win.walls), "failed": win.failed}
    if trace:
        t1 = time.perf_counter()
        summary = prof.summary(win.seconds, [CALL_SPAN, *labels])
        log(f"{cell.name}: trace reduced in {time.perf_counter() - t1:.3f} s")
        result["metrics"] = read_metrics(metrics, modules, summary, info)
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    else:
        result["metrics"] = read_metrics(metrics, modules, None, info)
    result["device"] = device

    t1 = time.perf_counter()
    checks = [("failed_calls", float(win.failed), 0.0)]
    checks += entry.verify(cell.config, cell.traffic, check_inputs, reservoir.samples(),
                           cell.check["limits"], devices)
    log(f"{cell.name}: {len(reservoir.kept)} calls checked in {time.perf_counter() - t1:.3f} s")
    result["correct"] = all(value <= limit for _, value, limit in checks)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result
