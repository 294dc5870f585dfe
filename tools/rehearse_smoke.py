#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phases 6 to 14 on the CPU, without a card.

    python tools/rehearse_smoke.py [--phases 67891011121314] [--scaling 6]

The port runs on the CPU, CUDA events and synchronization are replaced by
host clocks, the kron scaling rows shrink to the qubit counts given, the
large kron bootstrap to 4 resamples at 6 qubits, and phase 8's process
bootstraps to 2 qubits x 32 resamples and 1 qubit x 8 resamples (with no
launch expected of method='states': the CPU has no kernel), and phase 9's
rows to 2 qubits (the kron row to GHZ(3), put in kron mode by lowering
`StateTomograph.DENSE_POVM_MAX_ELEMENTS`), with few polytope margins and
small coverage runs, and phase 10's rows to 1-2 qubits and a few dozen
steps (its GHZ-4 and 4-qubit experiments become GHZ(2) and a 2-qubit
channel), and phase 11's records to GHZ(2), a kron GHZ(3) and that 2-qubit
channel, with small bootstraps and polytopes, the resumable bootstrap to
48 points in chunks of 16, and the examples to 1-3 qubits (no launch is
expected: the CPU has no kernel), and phase 12's mesh to 4 CPU shards,
1,024 resamples in (a), 6 qubits in (b) and short chains, process
bootstraps and coverage runs in (c)-(d), and phase 13's benchmark to a
2-qubit headline of 64 resamples at 10 iterations with 2-qubit rows (the
FP32 peak a stand-in of 1 TFLOP/s and its rate not held to phase 4's),
`entry()` at its full size and the dry run on 4 CPU shards, and phase 14's
chain-sampled flagship to phase 3's resample count at 2 qubits, its kron
draws to 4 qubits (the one-block equality to 3), its channel moments to 2
qubits at state chunks of 3 and 16 with 16 probes, its host pgdb to 1
qubit with 5 steps and its df32 row to 10^4 numbers. What it prints are
CPU readings: they check control flow, shapes and numerics, never the
card's times. It also prints how many L-BFGS evaluations (value and
gradient of the whole batch) phase 6 ran.
"""

from __future__ import annotations

import argparse
import math
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
    parser.add_argument("--phases", default="67891011121314",
                        help="which of phases 6-14 to run")
    parser.add_argument("--scaling", default="6", help="comma-separated kron scaling rows")
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    import chip_smoke
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch import bench, config
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
    chip_smoke.MCMC_STATE = (80, 50, 2)
    chip_smoke.MCMC_PROCESS = (1, 2_000, 40, 50, 2, 2)
    chip_smoke.MCMC_AUDIT_PROCESS = dict(chip_smoke.MCMC_AUDIT_PROCESS, mode_seek=2)
    chip_smoke.MCMC_BOOT_POINTS = 20
    chip_smoke.MCMC_FOUR = (20, 10, 10)
    chip_smoke.MCMC_PROJECTED_STEPS = 4
    chip_smoke.MCMC_HOLDER = (20, 20)
    chip_smoke.MCMC_IDLE_STEPS = 3
    chip_smoke.CLI_STATE = (64, 20)
    chip_smoke.CLI_KRON = (3, 2_000, 8)
    chip_smoke.CLI_PROCESS_POINTS = 8
    chip_smoke.RESUME = (48, 16, 2)
    chip_smoke.B1_PER_F32_BATCH = 0
    chip_smoke.EXAMPLE_BOOT = 32
    chip_smoke.EXAMPLE_REPEATS = 1
    chip_smoke.EXAMPLE_MAX_QUBITS = 3
    chip_smoke.EXAMPLE_QUALITY_REPEATS = 4
    chip_smoke.EXAMPLE_POSTERIOR = dict(n_qubits=1, n_shots=500, n_points=20, burn_steps=20,
                                        n_boot=20)
    chip_smoke.MESH_BOOT_POINTS = 1_024
    chip_smoke.MESH_KRON = (6,)
    chip_smoke.MESH_STATE_CHAINS = dict(n_points=160, burn_steps=100, n_chains=8)
    chip_smoke.MESH_KRAUS_CHAINS = dict(n_points=80, burn_steps=60, n_chains=8, mode_seek=50,
                                        curv_probes=4)
    chip_smoke.MESH_PROCESS = (32, 50)
    chip_smoke.MESH_COVERAGE_EXACT = 200
    chip_smoke.BENCH_RATE_REL = math.inf  # a CPU rate at 2 qubits against none
    chip_smoke.SURFACE_KRON = (4, 3)
    chip_smoke.SURFACE_CHANNEL = (2, 2_000, (3, 16), 16)
    chip_smoke.SURFACE_PGDB = (1, 2_000, 5, 100)
    chip_smoke.SURFACE_DF32_N = 10_000
    bench.N_QUBITS, bench.N_POINTS, bench.MLE_ITERS = 2, 64, 10
    bench.SCALING_QUBITS = (2,)
    bench.STATE_6Q = (2, 8)
    bench.STATE_10Q = (2, 4)
    bench.PROCESS_BOOT = (2, 2_000, 8)
    bench.fp32_peak_tflops = lambda device: 1.0  # the CPU has no card to read
    chip_smoke.device_busy_ms = lambda fn: (fn(), 0.0)[1]
    qtt.MHMCProcessInterval.PROJECTED_TARGET_QUBITS = 2  # the projected row at 2 qubits
    torch.cuda.Event = _HostEvent
    torch.cuda.synchronize = lambda *_: None
    torch.cuda.reset_peak_memory_stats = lambda *_: None
    torch.cuda.max_memory_allocated = lambda *_: 0
    torch.cuda.empty_cache = lambda *_: None
    chip_smoke.log_idle_share = lambda *_: None

    evaluations = 0
    value_and_grad = lbfgs._value_and_grad

    def counted(fun, x):
        nonlocal evaluations
        evaluations += 1
        return value_and_grad(fun, x)

    lbfgs._value_and_grad = counted
    card = "the CPU (rehearsal, not a device reading)"
    phases = args.phases
    for two_digits, letter in (("14", "V"), ("13", "W"), ("12", "Z"), ("11", "Y"), ("10", "X")):
        phases = phases.replace(two_digits, letter)
    if "6" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase6_cholesky_mle(card)
        print(f"phase 6: {time.perf_counter() - t0:.1f} s on the CPU; "
              f"L-BFGS evaluations {evaluations}")
    if "7" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase7_kron(card)
        print(f"phase 7: {time.perf_counter() - t0:.1f} s on the CPU")
    if "8" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase8_process(card)
        print(f"phase 8: {time.perf_counter() - t0:.1f} s on the CPU")
    # from phase 9 to 12, 2 qubits dense and 3 in kron mode (phase 6's and
    # phase 13's GHZ-4 stay dense)
    dense_max = qtt.StateTomograph.DENSE_POVM_MAX_ELEMENTS
    qtt.StateTomograph.DENSE_POVM_MAX_ELEMENTS = 1000
    if "9" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase9_intervals(card)
        print(f"phase 9: {time.perf_counter() - t0:.1f} s on the CPU")
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=2026)
    tmg.experiment(chip_smoke.N_SHOTS, "proj-set")
    est = tmg.point_estimate("mle-rhor")
    tmg4 = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=7)
    tmg4.experiment(2_000)
    tmg4.point_estimate("lifp")
    if "X" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase10_mcmc(card, tmg, est, tmg4)
        print(f"phase 10: {time.perf_counter() - t0:.1f} s on the CPU")
    if "Y" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase11_entry_points(card, tmg, tmg4, float("nan"))
        print(f"phase 11: {time.perf_counter() - t0:.1f} s on the CPU")
    if "Z" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase12_mesh(card, tmg, est, tmg4, float("nan"))
        print(f"phase 12: {time.perf_counter() - t0:.1f} s on the CPU")
    qtt.StateTomograph.DENSE_POVM_MAX_ELEMENTS = dense_max
    if "W" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase13_bench_and_entry(card, 1.0)
        print(f"phase 13: {time.perf_counter() - t0:.1f} s on the CPU")
    if "V" in phases:
        t0 = time.perf_counter()
        chip_smoke.phase14_surface(card, tmg, est)
        print(f"phase 14: {time.perf_counter() - t0:.1f} s on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
