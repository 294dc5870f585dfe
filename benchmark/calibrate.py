"""The readings the limits of `correct` are set from, for one cell on the
card: for each seed, the cell's set-up and `--calls` interval calls with
every sampler draw kept, then the compared numbers of the program against
the reference and, as control_<name>, those of the control (the reference
in the program's place in float32 with TF32 products). With `--fault`, a
fault of `benchmark.faults` planted under the sampler instead of the
control. One JSON line per seed on standard output.

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,13 [--calls 2]
        [--fault f] [--no-control]

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from pathlib import Path

import torch

from benchmark import faults, harness


def readings(root: Path, workload: str, seed: int, calls: int, device_type: str = "cuda",
             fault: str | None = None, control: bool = True) -> dict:
    cell = harness.Cell.load(root, workload)
    if device_type == "cuda":
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    else:
        devices = [torch.device("cpu")] * cell.chips
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    t0 = time.perf_counter()
    session = entry.Session(cell.config, cell.traffic, harness.derived_seed(seed, harness.SETUP),
                            devices)
    capture = harness.Capture()
    samples = []
    planted = {fault: faults.SAMPLER_FAULTS[fault]} if fault else {}
    with harness.spans.wrapped(planted, {fault: faults.SAMPLER}), \
            harness.spans.wrapped(capture.factories(entry.CAPTURE), entry.CAPTURE):
        for i in range(calls):
            capture.target = drawn = []
            d, q = session.call(harness.derived_seed(seed, harness.CALL, i))
            samples.append((i, (drawn, d, q)))
    capture.target = None
    inputs = session.release()
    t1 = time.perf_counter()
    out = entry.readings(cell.config, cell.traffic, inputs, samples, devices,
                         control=control and not fault)
    out.update(seed=seed, fault=fault, program_s=t1 - t0, check_s=time.perf_counter() - t1)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--calls", type=int, default=None,
                        help="calls per seed (default: the cell's checked_calls)")
    parser.add_argument("--fault", choices=sorted(faults.SAMPLER_FAULTS), default=None)
    parser.add_argument("--no-control", action="store_true", help="the program's readings only")
    args = parser.parse_args(argv)
    root = Path.cwd()
    if not torch.cuda.is_available():
        harness.log("no result: torch.cuda.is_available() is false")
        return 3
    calls = args.calls or int(harness.Cell.load(root, args.workload).check["checked_calls"])
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(root, args.workload, seed, calls, fault=args.fault,
                     control=not args.no_control)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
