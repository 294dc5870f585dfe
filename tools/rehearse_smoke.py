#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phases 6, 7, 8 and 9 on the CPU, without a card.

    python tools/rehearse_smoke.py [--phases 6789] [--scaling 6]

The port runs on the CPU, CUDA events and synchronization are replaced by
host clocks, the kron scaling rows shrink to the qubit counts given, the
large kron bootstrap to 4 resamples at 6 qubits, and phase 8's process
bootstraps to 2 qubits x 32 resamples and 1 qubit x 8 resamples (with no
launch expected of method='states': the CPU has no kernel), and phase 9's
rows to 2 qubits (the kron row to GHZ(3), put in kron mode by lowering
`StateTomograph.DENSE_POVM_MAX_ELEMENTS`), with few polytope margins and
small coverage runs. What it prints are
CPU readings: they check control flow, shapes and numerics, never the
card's times. It also prints how many L-BFGS evaluations (value and
gradient of the whole batch) phase 6 ran.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


class _HostEvent:
    """Stands in for torch.cuda.Event: the host clock at record()."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="6789", help="which of phases 6-9 to run")
    parser.add_argument("--scaling", default="6", help="comma-separated kron scaling rows")
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    import chip_smoke
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch import config
    from quantpy_tpu_torch.ops import lbfgs

    config.set_device("cpu")
    chip_smoke.DEVICE = "cpu"
    chip_smoke.KRON_SCALING = tuple(int(n) for n in args.scaling.split(","))
    chip_smoke.KRON_BOOT = (6, 4)
    chip_smoke.PROC_FLAGSHIP = (2, 2_000, 32)
    chip_smoke.PROC_MEDIAN_BAND = (0.05, 0.5)
    chip_smoke.PROC_EIGH_ROW = (1, 2_000, 8)
    chip_smoke.STATES_RHOR_LAUNCHES = 0
    chip_smoke.ANALYTIC_STATE = (2, 3_000, 20)
    chip_smoke.ANALYTIC_KRON = (3, 2_000, 10)
    chip_smoke.ANALYTIC_CHANNEL = (2, 2_000, 10)
    chip_smoke._lp_device_split = lambda *_: None
    chip_smoke.COVERAGE_QST = (2, 500, 300)
    chip_smoke.COVERAGE_QPT = (1, 500, 200)
    qtt.StateTomograph.DENSE_POVM_MAX_ELEMENTS = 1000  # 2 qubits dense, 3 in kron mode
    torch.cuda.Event = _HostEvent
    torch.cuda.synchronize = lambda *_: None
    torch.cuda.reset_peak_memory_stats = lambda *_: None
    torch.cuda.max_memory_allocated = lambda *_: 0
    chip_smoke.log_idle_share = lambda *_: None

    evaluations = 0
    value_and_grad = lbfgs._value_and_grad

    def counted(fun, x):
        nonlocal evaluations
        evaluations += 1
        return value_and_grad(fun, x)

    lbfgs._value_and_grad = counted
    card = "the CPU (rehearsal, not a device reading)"
    if "6" in args.phases:
        t0 = time.perf_counter()
        chip_smoke.phase6_cholesky_mle(card)
        print(f"phase 6: {time.perf_counter() - t0:.1f} s on the CPU; "
              f"L-BFGS evaluations {evaluations}")
    if "7" in args.phases:
        t0 = time.perf_counter()
        chip_smoke.phase7_kron(card)
        print(f"phase 7: {time.perf_counter() - t0:.1f} s on the CPU")
    if "8" in args.phases:
        t0 = time.perf_counter()
        chip_smoke.phase8_process(card)
        print(f"phase 8: {time.perf_counter() - t0:.1f} s on the CPU")
    if "9" in args.phases:
        t0 = time.perf_counter()
        chip_smoke.phase9_intervals(card)
        print(f"phase 9: {time.perf_counter() - t0:.1f} s on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
