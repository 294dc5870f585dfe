#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check or exception ends the run with a
non-zero exit code, and nothing falls back to the CPU:

0. Device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi) and the torch and CUDA versions.
1. Build both RrhoR kernels from quantpy_tpu_torch/csrc/ with nvcc
   (sm_90a), one nvcc per source, started together.
2. Each kernel (rhor_mle, the lane kernel; rhor_mle_flat, the flat-matrix
   kernel) against its plain PyTorch version on identical CUDA inputs
   (n = 1, 2, 3, 4, 5, 6 in float32, n = 2, 4 in float64, ragged batches,
   40 iterations), the two plain versions against each other in float64,
   then each kernel and its plain version timed in turns at the flagship
   shape (B = 16384, K = 1296, D = 256, 60 iterations) with CUDA events,
   beside the least time the card could take (`bound_ms`).
3. Main path: StateTomograph(GHZ(4)) built without device=, so on the
   default device, which must be "cuda"; a 10^4-shot proj-set experiment,
   the RrhoR point estimate (a single experiment: the plain loop, which
   stops at its tolerance) and a 16,384-resample bootstrap interval
   (RrhoR-60: one launch of the lane kernel), with the kernels' launch
   counts and the device of every tensor operation checked; then kernel
   and plain versions held against each other on one fixed draw of counts.
4. The bootstrap call's steady-state rate (best of 3) and its per-stage
   times, beside the card's name and power limit.
5. The flat kernel on the main path: the flagship bootstrap_distances call
   with kernels.rhor_mle replaced by kernels.rhor_mle_flat (as bench.py
   swaps the JAX kernels), launch counts and devices checked; flat and
   lane kernels held against each other on one fixed draw of counts; the
   rate of both variants, best of 3, in turns.
6. Cholesky MLE ('mle', batched L-BFGS) on the card: GHZ-4 point estimates
   ('mle-constr' must equal 'mle'), a 1,024-resample bootstrap interval
   audited for devices and for kernel launches (none), the per-resample
   likelihood of 'mle' beside RrhoR-60 on one fixed draw, the float64
   agreement of 'mle' and 'mle-rhor' at 2 qubits, and the bootstrap's rate
   and idle share (torch.profiler's device time against the call's time).
7. The kron-factored path on the card: its chains, lin and RrhoR against
   the dense path at 4 qubits; StateTomograph(GHZ(6)) in kron mode; the
   6-qubit 256-resample MLE bootstrap of bench.py, audited, with its rate
   and idle share; bench.py's
   scaling rows (6, 8, 10, 11 qubits: simulate, lin and MLE-60 times, hs to
   the truth, peak memory); bench.py's 10-qubit 16-resample bootstrap rate.

8. Process tomography on the card (no kernel of its own): at 2 qubits in
   float64 all four estimators of ProcessTomograph(depolarizing(0.1, 2))
   and the Newton-Schulz CP engine against eigh; lifp, the projection with
   both engines and states_to_choi_bloch on the card against the CPU on one
   set of counts; the launch counts of method='states' (one rhor_mle launch
   with 'mle-rhor' in float32, none with 'lin'); then the 4-qubit process
   bootstrap of bench.py (depolarizing(0.1, 4), 256 proj4 inputs, proj-set,
   2,000 shots per POVM, lifp + CPTP, 256 resamples, float32): audited for
   devices, float64 operations and kernel launches (none), each resampled
   Choi matrix checked for TP and CP, its rate, stage times, peak memory,
   idle share and the projection's TFLOP/s; and a 3-qubit 64-resample
   bootstrap on the 'eigh' engine (time and peak memory only).
9. The analytic confidence intervals on the card (no kernel of their own):
   (a) every interval of the slice (moment, Sugiyama, moment-fidelity,
   polytope on all three LP paths, Holder), count_delta and the coverage
   hits on 2-qubit tomographs in float64, the card against the CPU on the
   same counts (equal lp_iterations); (b) full-width rows in float32,
   each audited for devices, float64 operations and kernel launches (none),
   with times, radii or bounds, lp_iterations, peak memory and the
   polytopes' idle share and GEMM share; each polytope's two LP solves
   with their last residual readings, the margins that report the 1.0
   marker of a failed solve, and its other margins held to bracket the
   true point wherever it is feasible: GHZ-4 dense (1,000-margin
   polytope), the f32 polytope against a float64 rerun, GHZ-6 in kron mode
   (200 margins), depolarizing(0.1, 4) with 256 inputs (exact per-state
   moments, Holder's 256 children, the two-factor polytope at 50 margins)
   and its Hutchinson moments; (c) the coverage harness at 10^4 trials x 18
   levels (GHZ-4; 3-qubit QPT with sic inputs).

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

REPO = Path(__file__).resolve().parent

N_QUBITS = 4
N_SHOTS = 10_000
N_POINTS = 16_384
MLE_ITERS = 60
CHECK_ITERS = 40
TOL = {"float32": 5e-5, "float64": 1e-10}  # kernel vs plain, max |delta bloch|
TRACE_TOL = 1e-6  # out[:, 0] == 1/d
KERNELS = ("rhor_mle", "rhor_mle_flat")
# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 and FP64 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
# Kernel path vs plain on one fixed draw of counts: hs distances per resample
# in float64, and the interval's quantiles in float32, agree to HS_TOL. Per
# resample in float32 both sit up to ~2e-5 from the float64 result (measured
# on an H100 over four draws of 16,384), so there the bound is HS_TOL_F32,
# and the kernel must be no farther from float64 than the plain version.
HS_TOL = 1e-5
HS_TOL_F32 = 5e-5
MEDIAN_BAND = (1e-3, 2e-2)
DEVICE = "cuda"
# bench.py's kron-path workloads: the scaling rows' qubit counts, and the
# large MLE bootstrap (qubits, resamples)
KRON_SCALING = (6, 8, 10, 11)
KRON_BOOT = (10, 16)
# an estimate's hs distance to the true state must stay under this (the JAX
# package's TPU record is 0.0020-0.0035 at 6-11 qubits: a sanity band only)
TRUTH_HS_LIMIT = 0.01
# Phase 8. The flagship process bootstrap is bench.py's: qubits, shots per
# POVM, resamples. The JAX package records a median hs distance of
# 0.547-0.552 for it on its own draws (docs/benchmarks.md), and this script
# first read 0.5492 and 0.5494 on an H100: PROC_MEDIAN_BAND is a sanity band
# around both.
PROC_FLAGSHIP = (4, 2_000, 256)
PROC_MEDIAN_BAND = (0.45, 0.65)
PROC_EIGH_ROW = (3, 2_000, 64)  # qubits, shots, resamples of the 'eigh' engine row
PROC_SMALL_SHOTS = 10_000
# hs of a 2-qubit estimate from 10^4 shots to the true Choi matrix (trace 4):
# 0.05-0.08 over the four methods on the CPU in float64
PROC_SMALL_HS_LIMIT = 0.15
# 'dys' and 'pgdb' stop by different rules near one optimum: their raw-count
# NLLs lay 6e-7 and 2.5e-6 apart, relatively, on two seeds on the CPU in float64
PROC_NLL_REL = 1e-5
# ||Tr_out C - I||_F of a resampled Choi matrix: the bootstrap's 50 capped
# Dykstra iterations leave ~1.5e-2 (||I||_F = 4), far under the resamples'
# distances
PROC_TP_TOL = 5e-2
PROC_MIN_EIG = -1e-4
STATES_RHOR_LAUNCHES = 1  # rhor_mle launches of method='states' with 'mle-rhor' in float32
# Phase 9. The dense state row is phase 3's design (qubits, shots) with
# PolytopeStateInterval's default n_points; the kron row is phase 7's GHZ-6
# with the polytope at docs/benchmarks.md's measured n_points = 200; the
# channel row is phase 8's design with the two-factor polytope at 50 margins.
ANALYTIC_STATE = (4, 10_000, 1000)  # qubits, shots, polytope n_points
ANALYTIC_KRON = (6, 10_000, 200)
ANALYTIC_CHANNEL = (4, 2_000, 50)
ANALYTIC_LEVELS = (0.5, 0.9, 0.99)  # where each row's radii and bounds are printed
# the float32 polytope against a float64 rerun: tests/test_intervals.py's
# test_polytope_interval_f32_vs_x64 (n_points and tolerance)
ANALYTIC_F64_POINTS = 40
F32_F64_ATOL = 5e-3
# The rows' DeviceAudit passes cap every polytope LP at one 500-iteration
# chunk, and the idle shares of the three polytopes are read on runs capped
# at IDLE_LP_ITERS: every PDHG iteration runs the same operations, and the
# profiler stays at ~20k device events per run.
AUDIT_LP_ITERS = 500
IDLE_LP_ITERS = 1000
# A polytope's two LP solves (min, max) at full width are read as the
# stopping rule last read them. A margin whose solve leaves a violation over
# LP_FLAG_VIOL reports the bound 1.0 (interval._PolytopeBase._solve_with).
# Each row's target is its true state or channel, so the true point of the
# LP's variables is the min solve's objective vector c: wherever the true
# point lies in a margin's polytope, an exact min and max bracket <c, c>;
# TRUE_POINT_SLACK is that check's slack relative to 1 + <c, c>.
LP_FLAG_VIOL = 1e-3
TRUE_POINT_SLACK = 1e-3
# the Hutchinson channel moments (128 probes) against the exact ones: the
# mean is exact, the variance within tests/test_intervals.py's 5%
STOCH_MEAN_REL = 1e-6
STOCH_VAR_REL = 0.05
# the paper's fig. 1 coverage harness: qubits, shots per POVM, trials
COVERAGE_QST = (4, 10_000, 10_000)
COVERAGE_QPT = (3, 10_000, 10_000)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Best of `reps` CUDA-event timings of fn(), in milliseconds."""
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def device_busy_ms(fn) -> float:
    """The card's busy time in one call of fn(), in milliseconds: the sum of
    the durations of the kernels and copies that torch.profiler records on
    the device (0.0 if it records none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def idle_share(busy_ms, wall_ms):
    """1 - busy / wall as printed: unclamped, so that a busy time above the
    wall time (work counted twice) shows as a negative share, and named."""
    if busy_ms <= 0:
        return "not measured (the profiler recorded no device time)"
    share = f"{1.0 - busy_ms / wall_ms:.3f}"
    if busy_ms > wall_ms:
        share += " (the profiler's busy time exceeds the call's wall time)"
    return share


def log_idle_share(what, fn, wall_ms):
    """Print the device's busy time in one more call of fn() beside the
    call's unprofiled wall time `wall_ms`, and the idle share."""
    busy = device_busy_ms(fn)
    log(f"    {what}: device busy {busy:.3f} ms of a {wall_ms:.3f} ms call; "
        f"idle share {idle_share(busy, wall_ms)}")


def phase0_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    if not all((REPO / "quantpy_tpu_torch" / "csrc" / f"{k}.cu").is_file() for k in KERNELS):
        raise SystemExit("chip_smoke: run from a checkout of the repository; no result")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"device 0: {torch.cuda.get_device_name(0)}; cards visible: {torch.cuda.device_count()}")
    return card


def phase1_build():
    from quantpy_tpu_torch.ops import _build, kernels

    log(f"[1] building {', '.join(k + '.cu' for k in KERNELS)} with {_build.nvcc_path()}")
    nvcc_version = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    log(f"    {nvcc_version}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    for name in KERNELS:
        kernels._library(name)
    log(f"    build + load of both: {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        seconds, output = _build.build_log.get(name, (0.0, ""))
        log(f"    {name}: nvcc {seconds:.2f} s")
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas: {line.strip()}")


def _problem(n_qubits, batch, dtype, povm, shots, seed):
    """A real RrhoR problem on the card: counts drawn from GHZ(n) with the
    given design, lin starts mixed 5% toward I/d, weighted POVM rows * d."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.tomography import state_core

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    povm_m = torch.as_tensor(qtt.generate_measurement_matrix(povm, n_qubits), dtype=dtype, device=dev)
    n_meas = torch.full((povm_m.shape[0],), float(shots), dtype=dtype, device=dev)
    truth = qtt.GHZ(n_qubits).bloch_tensor(dev, dtype)
    counts = state_core.simulate_experiment(gen, povm_m, truth.expand(batch, -1), n_meas)
    init = state_core.estimate_lin(counts, povm_m, n_meas)
    d = 2**n_qubits
    mixed = torch.zeros_like(init)
    mixed[:, 0] = 1.0 / d
    bloch0 = (0.95 * init + 0.05 * mixed).contiguous()
    freq = counts.reshape(batch, -1)
    freq = (freq / freq.sum(-1, keepdim=True)).contiguous()
    w2 = (state_core.weighted_povm_flat(povm_m, n_meas) * d).contiguous()
    return freq, bloch0, w2


def _in_turns(kernel, plain, reps):
    """Best CUDA-event times (kernel_ms, plain_ms) of `reps` calls each, in
    turns on one card: plain, kernel, kernel, plain."""
    plain_ms = cuda_ms(plain, reps)
    kernel_ms = cuda_ms(kernel, reps)
    kernel_ms = min(kernel_ms, cuda_ms(kernel, reps))
    plain_ms = min(plain_ms, cuda_ms(plain, reps))
    return kernel_ms, plain_ms


def phase2_kernel_vs_plain():
    from quantpy_tpu_torch.ops import kernels

    log("[2] kernels against their plain versions on identical inputs")
    pairs = {
        "rhor_mle": (kernels.rhor_mle, kernels.rhor_mle_reference),
        "rhor_mle_flat": (kernels.rhor_mle_flat, kernels.rhor_mle_flat_reference),
    }
    cases = [
        (1, torch.float32, "proj-set", 37),
        (2, torch.float32, "proj-set", 37),
        (3, torch.float32, "proj-set", 29),
        (4, torch.float32, "proj-set", 37),
        (5, torch.float32, "proj-set", 11),
        (6, torch.float32, "sic", 13),
        (2, torch.float64, "proj-set", 37),
        (4, torch.float64, "proj-set", 37),
    ]
    worst_f32 = dict.fromkeys(pairs, 0.0)
    for n, dtype, povm, batch in cases:
        freq, bloch0, w2 = _problem(n, batch, dtype, povm, N_SHOTS, seed=100 + n)
        name = str(dtype).removeprefix("torch.")
        for kname, (kernel, plain) in pairs.items():
            out = kernel(freq, bloch0, w2, CHECK_ITERS)
            torch.cuda.synchronize()
            ref = plain(freq, bloch0, w2, CHECK_ITERS)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            trace_err = float((out[:, 0] - 1.0 / 2**n).abs().max())
            log(f"    {kname:13s} n={n} {name:7s} {povm:8s} B={batch} K={w2.shape[0]} "
                f"D={w2.shape[1]}: max|kernel-plain| {err:.3e} (limit {TOL[name]:.0e}), "
                f"max|out0 - 1/d| {trace_err:.3e}")
            if not (math.isfinite(err) and err <= TOL[name]):
                raise AssertionError(f"{kname} disagrees with plain at n={n} {name}: {err}")
            if not trace_err <= TRACE_TOL:
                raise AssertionError(f"{kname} output off unit trace at n={n} {name}: {trace_err}")
            if dtype == torch.float32:
                worst_f32[kname] = max(worst_f32[kname], err)

    # both plain versions run the same iterates in exact arithmetic
    freq, bloch0, w2 = _problem(N_QUBITS, 37, torch.float64, "proj-set", N_SHOTS, seed=104)
    err = float((kernels.rhor_mle_flat_reference(freq, bloch0, w2, CHECK_ITERS)
                 - kernels.rhor_mle_reference(freq, bloch0, w2, CHECK_ITERS)).abs().max())
    log(f"    flat plain vs lane plain, n={N_QUBITS} float64: max|delta| {err:.3e} "
        f"(limit {TOL['float64']:.0e})")
    if not err <= TOL["float64"]:
        raise AssertionError(f"the flat and lane plain versions disagree in float64: {err}")

    k, d2, d = w2.shape[0], w2.shape[1], 2**N_QUBITS
    # the multiply-adds each kernel's loop runs per resample-iteration with
    # dense PTM maps (the dense count), and the function's least work: the
    # Hermitian state folded to D real entries needs no PTM inside the loop,
    # two K x D POVM products, S = R t in full (4 d^3) and only the D real
    # entries of the Hermitian S R (2 d^3); the flat kernel runs exactly that
    dense_macs = {"rhor_mle": 2 * k * d2 + 6 * d2**2 + 8 * d**3,
                  "rhor_mle_flat": 2 * k * d2 + 6 * d**3}
    least_macs = 2 * k * d2 + 6 * d**3
    measured = {}
    for dtype, reps in ((torch.float32, 2), (torch.float64, 1)):
        name = str(dtype).removeprefix("torch.")
        freq, bloch0, w2 = _problem(N_QUBITS, N_POINTS, dtype, "proj-set", N_SHOTS, seed=7)
        bound = _bound(freq, bloch0, w2, least_macs, name)
        for kname, (kernel, plain) in pairs.items():
            run_plain = lambda: plain(freq, bloch0, w2, MLE_ITERS)  # noqa: E731
            run_kernel = lambda: kernel(freq, bloch0, w2, MLE_ITERS)  # noqa: E731
            err = float((run_kernel() - run_plain()).abs().max())
            torch.cuda.synchronize()
            kernel_ms, plain_ms = _in_turns(run_kernel, run_plain, reps)
            flops = 2.0 * MLE_ITERS * N_POINTS * dense_macs[kname]
            log(f"    {kname} flagship B={N_POINTS} K={k} D={d2} iters={MLE_ITERS} {name}: "
                f"kernel {kernel_ms:.3f} ms ({flops / kernel_ms / 1e9:.2f} dense-count TFLOP/s), "
                f"plain {plain_ms:.3f} ms ({flops / plain_ms / 1e9:.2f} dense-count TFLOP/s), "
                f"bound {bound['bound_ms']:.3f} ms ({least_macs} MACs per resample-iteration "
                f"at {PEAK_FLOPS[name] / 1e12:.0f} TFLOP/s), kernel at "
                f"{bound['bound_ms'] / kernel_ms:.3f} of the bound, max|kernel-plain| {err:.3e}")
            if not (math.isfinite(err) and err <= TOL[name]):
                raise AssertionError(f"{kname} disagrees with plain at the flagship shape: {err}")
            if dtype == torch.float32:
                measured[kname] = {"max_abs_err": max(worst_f32[kname], err),
                                   "ms": kernel_ms, "plain_ms": plain_ms, **bound,
                                   "bound_share": bound["bound_ms"] / kernel_ms,
                                   "library_ms": None}
    return measured


def _bound(freq, bloch0, w2, macs, dtype_name):
    """The least time of one flagship call on the card, in ms: the larger of
    its least operations over the peak rate and its bytes (each input read
    once, the output written once) over the memory rate."""
    ops_ms = 2.0 * MLE_ITERS * freq.shape[0] * macs / PEAK_FLOPS[dtype_name] * 1e3
    n_bytes = freq.element_size() * (freq.numel() + 2 * bloch0.numel() + w2.numel())
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


class DeviceAudit(TorchDispatchMode):
    """Records every aten operation whose tensor inputs or outputs are not
    on the card, other than copies between devices, aliases of uploaded
    host arrays and 0-dim scalars."""

    COPIES = {
        "_to_copy", "copy_", "_copy_from", "lift_fresh", "lift_fresh_copy", "to",
        "detach", "alias",
    }

    def __init__(self):
        super().__init__()
        self.n_ops = 0
        self.off_device: set[str] = set()
        self.wide: set[str] = set()  # operations on float64 / complex128 tensors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.n_ops += 1
        if name not in self.COPIES:
            for t in tree_flatten((args, kwargs, out))[0]:
                if not (isinstance(t, torch.Tensor) and t.dim() > 0):
                    continue
                if t.device.type != DEVICE:
                    self.off_device.add(f"{name} ({t.device})")
                if t.dtype in (torch.float64, torch.complex128):
                    self.wide.add(name)
        return out


def phase3_main_path(card):
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.tomography import bootstrap_core, state_core

    log("[3] main path on cuda")
    audit = DeviceAudit()
    kernels.rhor_mle.launches = 0
    kernels.rhor_mle_flat.launches = 0
    t0 = time.perf_counter()
    with audit:
        tmg = qtt.StateTomograph(qtt.GHZ(N_QUBITS), key=2026)  # the default device
        tmg.experiment(N_SHOTS, "proj-set")
        est = tmg.point_estimate("mle-rhor")
        interval = qtt.BootstrapStateInterval(
            tmg, n_points=N_POINTS, method="mle-rhor", max_iter=MLE_ITERS, key=0
        )
        levels = (0.5, 0.9, 0.99)
        dists, _ = interval(levels)
        torch.cuda.synchronize()
    launches = kernels.rhor_mle.launches
    flat_launches = kernels.rhor_mle_flat.launches
    wall = time.perf_counter() - t0
    infid = float(qtt.if_dst(est, qtt.GHZ(N_QUBITS)))
    sample = interval.distances
    median = float(np.median(sample))
    default_counts = tmg.simulate_batch(2)
    log(f"    StateTomograph without device=: device {tmg.device}, generator "
        f"{tmg.generator.device}, simulated counts on {default_counts.device}")
    if not (tmg.device.type == tmg.generator.device.type == default_counts.device.type
            == DEVICE):
        raise AssertionError(f"the default device is not {DEVICE}: {tmg.device}")
    log(f"    point estimate infidelity to GHZ-4: {infid:.3e}")
    log(f"    bootstrap hs distances at {levels}: {[float(x) for x in dists]}; "
        f"median {median:.4e}; first run {wall:.2f} s with the audit on")
    log(f"    rhor_mle launches in the main path: {launches} (rhor_mle_flat: {flat_launches}); "
        f"aten ops audited: {audit.n_ops}")
    if sample.shape != (N_POINTS,) or not np.all(np.isfinite(sample)):
        raise AssertionError("bootstrap distances are not finite or of the wrong shape")
    if not MEDIAN_BAND[0] <= median <= MEDIAN_BAND[1]:
        raise AssertionError(f"bootstrap median {median} outside {MEDIAN_BAND}")
    if not 0 <= infid < 1e-2:
        raise AssertionError(f"point estimate infidelity {infid} is implausible")
    if launches != 1:
        raise AssertionError(
            f"the main path launched rhor_mle {launches} times; the interval's batch "
            "launches it once and the single-experiment point estimate runs the plain loop")
    if flat_launches != 0:
        raise AssertionError("the main path launched the flat kernel; it dispatches to rhor_mle")
    if audit.off_device:
        raise AssertionError(f"operations off the card: {sorted(audit.off_device)}")

    # kernel path against the plain version on one fixed draw of counts
    gen = torch.Generator(device=tmg.device)
    gen.manual_seed(99)
    counts = tmg.simulate_batch(N_POINTS, state=est, generator=gen)
    hs = {}
    for dtype in (torch.float32, torch.float64):
        bloch_est = est.bloch_tensor(tmg.device, dtype)
        povm = torch.as_tensor(tmg.povm_matrix, dtype=dtype, device=tmg.device)
        n_meas = torch.as_tensor(tmg.n_measurements, dtype=dtype, device=tmg.device)
        c = counts.to(dtype)
        init = state_core.estimate_lin(c, povm, n_meas)
        d = 2**N_QUBITS
        mixed = torch.zeros_like(init)
        mixed[:, 0] = 1.0 / d
        freq = c.reshape(N_POINTS, -1)
        freq = freq / freq.sum(-1, keepdim=True)
        a2 = state_core.weighted_povm_flat(povm, n_meas) * d
        bloch0 = (0.95 * init + 0.05 * mixed).contiguous()
        via_kernel = kernels.rhor_mle(freq.contiguous(), bloch0, a2.contiguous(), MLE_ITERS)
        via_plain = kernels.rhor_mle_reference(freq, bloch0, a2, MLE_ITERS)
        for name, blochs in (("kernel", via_kernel), ("plain", via_plain)):
            hs[name, dtype] = bootstrap_core._distance_batch(
                "hs", blochs, bloch_est, N_QUBITS).double()
    f32, f64 = torch.float32, torch.float64

    def worst(a, b):
        return float((hs[a] - hs[b]).abs().max())

    def quantiles(key):
        return torch.quantile(hs[key], torch.tensor(levels, dtype=f64, device=tmg.device))

    q_err = float((quantiles(("kernel", f32)) - quantiles(("plain", f32))).abs().max())
    err64 = worst(("kernel", f64), ("plain", f64))
    err32 = worst(("kernel", f32), ("plain", f32))
    k_vs_64 = worst(("kernel", f32), ("plain", f64))
    p_vs_64 = worst(("plain", f32), ("plain", f64))
    log(f"    fixed draw, {N_POINTS} resamples, max|delta hs|: kernel-plain f64 {err64:.3e} "
        f"(limit {HS_TOL:.0e}); kernel-plain f32 quantiles at {levels} {q_err:.3e} "
        f"(limit {HS_TOL:.0e}); kernel-plain f32 per resample {err32:.3e} "
        f"(limit {HS_TOL_F32:.0e}); to the f64 result: kernel f32 {k_vs_64:.3e}, "
        f"plain f32 {p_vs_64:.3e}")
    if not err64 <= HS_TOL:
        raise AssertionError(f"kernel and plain hs distances disagree in float64: {err64}")
    if not q_err <= HS_TOL:
        raise AssertionError(f"kernel and plain hs quantiles disagree in float32: {q_err}")
    if not err32 <= HS_TOL_F32:
        raise AssertionError(f"kernel and plain hs distances disagree in float32: {err32}")
    if not k_vs_64 <= 1.5 * p_vs_64:
        raise AssertionError(
            f"kernel float32 hs error {k_vs_64} exceeds 1.5x the plain version's {p_vs_64}")
    return tmg, est, launches


def phase4_rate(card, tmg, est):
    from quantpy_tpu_torch.tomography import bootstrap_core, state_core

    log("[4] bootstrap rate (informational)")
    dev, dtype = tmg.device, tmg.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bloch_est = est.bloch_tensor(dev, dtype)
    povm = torch.as_tensor(tmg.povm_matrix, dtype=dtype, device=dev)
    n_meas = torch.as_tensor(tmg.n_measurements, dtype=dtype, device=dev)

    def call():
        return bootstrap_core.bootstrap_distances(
            gen, bloch_est, povm, n_meas, n_points=N_POINTS, method="mle-rhor",
            max_iter=MLE_ITERS,
        )

    call()
    ms = cuda_ms(call, 3)
    log(f"    bootstrap_distances, {N_POINTS} resamples, RrhoR-{MLE_ITERS}: best of 3 "
        f"{ms:.3f} ms = {N_POINTS / ms * 1e3:.1f} resamples/s on {card}")

    blochs = bloch_est.expand(N_POINTS, -1)
    n = N_QUBITS
    counts = state_core.simulate_experiment(gen, povm, blochs, n_meas)
    raw = state_core.estimate_lin(counts, povm, n_meas, physical=False)
    init = state_core.make_feasible_bloch(raw, n)
    est_b = state_core.estimate_mle_rhor(counts, povm, n_meas, init, max_iter=MLE_ITERS)
    stages = {
        "simulate": lambda: state_core.simulate_experiment(gen, povm, blochs, n_meas),
        "lin_solve": lambda: state_core.estimate_lin(counts, povm, n_meas, physical=False),
        "eigh_clip": lambda: state_core.make_feasible_bloch(raw, n),
        "rhor_kernel": lambda: state_core.estimate_mle_rhor(
            counts, povm, n_meas, init, max_iter=MLE_ITERS),
        "hs_distance": lambda: bootstrap_core._distance_batch("hs", est_b, bloch_est, n),
    }
    times = {name: cuda_ms(fn, 3) for name, fn in stages.items()}
    log("    stages (ms, best of 3): " + json.dumps({k: round(v, 3) for k, v in times.items()}))
    return ms


@contextlib.contextmanager
def flat_kernel_on_main_path():
    """Swap kernels.rhor_mle for kernels.rhor_mle_flat for one block (as
    bench.py swaps the JAX kernels); yields the lane kernel's wrapper."""
    from quantpy_tpu_torch.ops import kernels

    lane = kernels.rhor_mle
    kernels.rhor_mle = kernels.rhor_mle_flat
    try:
        yield lane
    finally:
        kernels.rhor_mle = lane


def _fixed_draw_hs(tmg, est, seed):
    """hs distances to `est` of one fixed draw of N_POINTS resamples,
    estimated by RrhoR-60 through kernels.rhor_mle (the lane kernel, or the
    flat one where it is swapped in) in float32 and float64."""
    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.tomography import bootstrap_core, state_core

    gen = torch.Generator(device=tmg.device)
    gen.manual_seed(seed)
    counts = tmg.simulate_batch(N_POINTS, state=est, generator=gen)
    hs = {}
    for dtype in (torch.float32, torch.float64):
        bloch_est = est.bloch_tensor(tmg.device, dtype)
        povm = torch.as_tensor(tmg.povm_matrix, dtype=dtype, device=tmg.device)
        n_meas = torch.as_tensor(tmg.n_measurements, dtype=dtype, device=tmg.device)
        c = counts.to(dtype)
        init = state_core.estimate_lin(c, povm, n_meas)
        d = 2**N_QUBITS
        freq = c.reshape(N_POINTS, -1)
        freq = (freq / freq.sum(-1, keepdim=True)).contiguous()
        bloch0 = state_core._mixed_start(init, d, 0.05).contiguous()
        a2 = (state_core.weighted_povm_flat(povm, n_meas) * d).contiguous()
        blochs = kernels.rhor_mle(freq, bloch0, a2, MLE_ITERS)
        hs[dtype] = bootstrap_core._distance_batch("hs", blochs, bloch_est, N_QUBITS).double()
    return hs


def phase5_flat_path(card, tmg, est):
    import numpy as np

    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.tomography import bootstrap_core

    log("[5] flat kernel on the main path")
    dev, dtype = tmg.device, tmg.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    bloch_est = est.bloch_tensor(dev, dtype)
    povm = torch.as_tensor(tmg.povm_matrix, dtype=dtype, device=dev)
    n_meas = torch.as_tensor(tmg.n_measurements, dtype=dtype, device=dev)

    def call():
        return bootstrap_core.bootstrap_distances(
            gen, bloch_est, povm, n_meas, n_points=N_POINTS, method="mle-rhor",
            max_iter=MLE_ITERS,
        )

    audit = DeviceAudit()
    kernels.rhor_mle.launches = 0
    kernels.rhor_mle_flat.launches = 0
    with flat_kernel_on_main_path() as lane:
        with audit:
            dists = call()
            torch.cuda.synchronize()
    flat_launches = kernels.rhor_mle_flat.launches
    lane_launches = lane.launches
    sample = dists.double().cpu().numpy()
    median = float(np.median(sample))
    log(f"    bootstrap_distances with the flat kernel: median hs {median:.4e}; "
        f"rhor_mle_flat launches {flat_launches}, rhor_mle launches {lane_launches}; "
        f"aten ops audited: {audit.n_ops}")
    if sample.shape != (N_POINTS,) or not np.all(np.isfinite(sample)):
        raise AssertionError("flat-path distances are not finite or of the wrong shape")
    if not MEDIAN_BAND[0] <= median <= MEDIAN_BAND[1]:
        raise AssertionError(f"flat-path bootstrap median {median} outside {MEDIAN_BAND}")
    if flat_launches < 1:
        raise AssertionError("the flat path never launched the rhor_mle_flat kernel")
    if lane_launches != 0:
        raise AssertionError(f"the flat path launched the lane kernel {lane_launches} times")
    if audit.off_device:
        raise AssertionError(f"operations off the card: {sorted(audit.off_device)}")

    # flat kernel against the lane kernel on one fixed draw of counts
    lane_hs = _fixed_draw_hs(tmg, est, seed=99)
    with flat_kernel_on_main_path():
        flat_hs = _fixed_draw_hs(tmg, est, seed=99)
    f32, f64 = torch.float32, torch.float64
    levels = torch.tensor((0.5, 0.9, 0.99), dtype=f64, device=dev)
    q_flat = torch.quantile(flat_hs[f32], levels)
    q_lane = torch.quantile(lane_hs[f32], levels)
    q_err = float((q_flat - q_lane).abs().max())
    err32 = float((flat_hs[f32] - lane_hs[f32]).abs().max())
    err64 = float((flat_hs[f64] - lane_hs[f64]).abs().max())
    log(f"    fixed draw, {N_POINTS} resamples: hs quantiles at {levels.tolist()} flat "
        f"{q_flat.tolist()}, lane {q_lane.tolist()}; max|flat-lane| quantiles f32 "
        f"{q_err:.3e} (limit {HS_TOL:.0e}), per resample f32 {err32:.3e} "
        f"(limit {HS_TOL_F32:.0e}), f64 {err64:.3e} (limit {HS_TOL:.0e})")
    if not q_err <= HS_TOL:
        raise AssertionError(f"flat and lane hs quantiles disagree in float32: {q_err}")
    if not err32 <= HS_TOL_F32:
        raise AssertionError(f"flat and lane hs distances disagree in float32: {err32}")
    if not err64 <= HS_TOL:
        raise AssertionError(f"flat and lane hs distances disagree in float64: {err64}")

    # the rate of both variants, best of 3, in turns
    lane_ms = flat_ms = math.inf
    for _ in range(3):
        lane_ms = min(lane_ms, cuda_ms(call, 1))
        with flat_kernel_on_main_path():
            flat_ms = min(flat_ms, cuda_ms(call, 1))
    log(f"    bootstrap_distances, {N_POINTS} resamples, RrhoR-{MLE_ITERS}, best of 3 in turns "
        f"on {card}: flat kernel {flat_ms:.3f} ms = {N_POINTS / flat_ms * 1e3:.1f} resamples/s, "
        f"lane kernel {lane_ms:.3f} ms = {N_POINTS / lane_ms * 1e3:.1f} resamples/s")
    return flat_launches


def _reset_launches():
    from quantpy_tpu_torch.ops import kernels

    kernels.rhor_mle.launches = 0
    kernels.rhor_mle_flat.launches = 0


def _check_no_kernel_and_on_card(audit, what):
    """Neither RrhoR kernel launched since `_reset_launches`, and `audit`
    saw no operation off the card."""
    from quantpy_tpu_torch.ops import kernels

    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    log(f"    {what}: rhor_mle / rhor_mle_flat launches {launched}; aten ops audited: "
        f"{audit.n_ops}")
    if launched != (0, 0):
        raise AssertionError(f"{what} launched an RrhoR kernel: {launched}")
    if audit.off_device:
        raise AssertionError(f"{what}: operations off the card: {sorted(audit.off_device)}")


def _check_distances(sample, n_points, what):
    import numpy as np

    median = float(np.median(sample))
    if sample.shape != (n_points,) or not np.all(np.isfinite(sample)):
        raise AssertionError(f"{what}: distances not finite or of the wrong shape")
    if not MEDIAN_BAND[0] <= median <= MEDIAN_BAND[1]:
        raise AssertionError(f"{what}: median {median} outside {MEDIAN_BAND}")
    return median


def phase6_cholesky_mle(card):
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.tomography import bootstrap_core, state_core

    log("[6] Cholesky MLE ('mle', batched L-BFGS) on the card")
    tmg = qtt.StateTomograph(qtt.GHZ(N_QUBITS), key=606)  # the default device, float32
    tmg.experiment(N_SHOTS, "proj-set")
    est = tmg.point_estimate("mle")
    constr = tmg.point_estimate("mle-constr")
    infid = float(qtt.if_dst(est, qtt.GHZ(N_QUBITS)))
    log(f"    point estimate 'mle' on {tmg.device} ({tmg.dtype}): infidelity to GHZ-4 "
        f"{infid:.3e}; 'mle-constr' equal: {np.array_equal(constr.bloch, est.bloch)}")
    if not np.array_equal(constr.bloch, est.bloch):
        raise AssertionError("'mle-constr' differs from 'mle'")
    if not 0 <= infid < 1e-2:
        raise AssertionError(f"'mle' point estimate infidelity {infid} is implausible")

    n_points, max_iter = 1024, 100
    _reset_launches()
    audit = DeviceAudit()
    t0 = time.perf_counter()
    with audit:
        interval = qtt.BootstrapStateInterval(
            tmg, n_points=n_points, method="mle", max_iter=max_iter, key=6, state=est
        )
        dists, _ = interval((0.5, 0.9, 0.99))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    median = _check_distances(interval.distances, n_points, "'mle' bootstrap")
    log(f"    BootstrapStateInterval('mle', {n_points} resamples, max_iter {max_iter}): hs at "
        f"(0.5, 0.9, 0.99) {[float(x) for x in dists]}; median {median:.4e}; first run "
        f"{wall:.2f} s with the audit on")
    _check_no_kernel_and_on_card(audit, "the 'mle' bootstrap")

    # 'mle' beside RrhoR-60 on one fixed draw
    dev = tmg.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(66)
    counts = tmg.simulate_batch(n_points, state=est, generator=gen)
    povm = torch.as_tensor(tmg.povm_matrix, dtype=tmg.dtype, device=dev)
    n_meas = torch.as_tensor(tmg.n_measurements, dtype=tmg.dtype, device=dev)
    chol = state_core.estimate(counts, povm, n_meas, method="mle", max_iter=max_iter)
    rhor = state_core.estimate(counts, povm, n_meas, method="mle-rhor", max_iter=MLE_ITERS)
    f64 = torch.float64
    a = state_core.weighted_povm_flat(povm.to(f64), n_meas.to(f64))
    freq = counts.to(f64).reshape(n_points, -1)
    freq = freq / freq.sum(-1, keepdim=True)

    def nll(blochs):  # float32 rounding leaves some zero probabilities just below 0
        probs = (blochs.to(f64) @ a.T * 2**N_QUBITS).clamp(min=0.0)
        return -(freq * torch.log(probs + 1e-10)).sum(-1)

    nll_chol, nll_rhor = nll(chol), nll(rhor)
    gap = nll_chol - nll_rhor
    apart = bootstrap_core._distance_batch("hs", chol.to(f64), rhor.to(f64), N_QUBITS)
    log(f"    fixed draw of {n_points}: median NLL 'mle' {float(nll_chol.median()):.9f}, "
        f"RrhoR-{MLE_ITERS} {float(nll_rhor.median()):.9f}; NLL 'mle' - NLL RrhoR-{MLE_ITERS} "
        f"per resample (float64 of the float32 estimates): median {float(gap.median()):.3e}, "
        f"min {float(gap.min()):.3e}, "
        f"max {float(gap.max()):.3e}; hs apart: median {float(apart.median()):.3e}, "
        f"max {float(apart.max()):.3e}")
    if not bool(torch.isfinite(gap).all()):
        raise AssertionError("the fixed draw's likelihoods are not finite")

    # both maximize the same likelihood: agreement in float64 at 2 qubits
    tmg2 = qtt.StateTomograph(qtt.GHZ(2), key=4, dtype=f64)
    tmg2.experiment(5000, "proj-set")
    b_chol = tmg2.estimate_batch(tmg2.results, "mle", max_iter=300, tol=1e-6)
    b_rhor = tmg2.estimate_batch(tmg2.results, "mle-rhor", max_iter=3000)
    hs2 = float(qtt.hs_dst(qtt.Qobj(b_chol.cpu().numpy()), qtt.Qobj(b_rhor.cpu().numpy())))
    log(f"    float64, GHZ-2, 5000 shots: hs('mle' max_iter 300 tol 1e-6, 'mle-rhor' 3000) "
        f"{hs2:.3e} (limit 5e-4)")
    if not hs2 < 5e-4:
        raise AssertionError(f"'mle' and 'mle-rhor' disagree in float64: hs {hs2}")

    bloch_est = est.bloch_tensor(dev, tmg.dtype)

    def call():
        return bootstrap_core.bootstrap_distances(
            gen, bloch_est, povm, n_meas, n_points=n_points, method="mle", max_iter=max_iter
        )

    ms = cuda_ms(call, 3)
    log(f"    bootstrap_distances('mle'), {n_points} resamples, max_iter {max_iter}: best of 3 "
        f"{ms:.3f} ms = {n_points / ms * 1e3:.1f} resamples/s on {card}")
    log_idle_share("the 'mle' bootstrap call", call, ms)


def _kron_dense_checks():
    """The kron chains, lin and RrhoR at 4 qubits against the dense path."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.tomography import kron_core, state_core

    n, dev = 4, torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(44)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-8)):
        povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=dtype, device=dev)
        povm = torch.as_tensor(qtt.generate_measurement_matrix("proj-set", n), dtype=dtype,
                               device=dev)
        n_meas = torch.full((povm.shape[0],), float(N_SHOTS), dtype=dtype, device=dev)
        truth = qtt.GHZ(n).bloch_tensor(dev, dtype)
        counts = kron_core.kron_simulate(gen, povm1, truth.expand(64, -1), N_SHOTS)
        freq = counts / counts.sum(-1, keepdim=True)
        blochs = state_core.estimate_lin(counts, povm, n_meas)
        errs = {
            "probs": kron_core.kron_probs(povm1, n, blochs)
            - state_core.experiment_probabilities(povm, blochs),
            "adjoint": kron_core.kron_apply_adjoint(povm1, n, freq)
            - torch.einsum("zmp,mpd->zd", freq, povm),
        }
        if dtype == torch.float64:
            errs["lin"] = (kron_core.kron_estimate_lin(counts, povm1, n)
                           - state_core.estimate_lin(counts, povm, n_meas))
            init = kron_core.kron_estimate_lin(counts, povm1, n)
            w2 = state_core.weighted_povm_flat(povm, n_meas) * 2**n
            plain = kernels.rhor_mle_reference(
                freq.reshape(64, -1) / freq.shape[-2], state_core._mixed_start(init, 2**n, 0.05),
                w2, MLE_ITERS)
            errs["rhor"] = kron_core.kron_estimate_mle_rhor(
                counts, povm1, n, max_iter=MLE_ITERS, tol=0.0) - plain
        errs = {k: float(v.abs().max()) for k, v in errs.items()}
        log(f"    n={n} {str(dtype).removeprefix('torch.')}: kron - dense max|delta| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {tol:.0e})")
        if not all(math.isfinite(v) and v <= tol for v in errs.values()):
            raise AssertionError(f"the kron path disagrees with the dense one: {errs}")


def _scaling_row(n, povm1, truth, gen):
    """bench.py's scaling row at n qubits: one 10^4-shot simulation, lin and
    MLE-60 of it, CUDA-event times, hs to the truth, peak memory."""
    from quantpy_tpu_torch.tomography import bootstrap_core, kron_core

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end)
        return result

    counts = timed("simulate_ms", lambda: kron_core.kron_simulate(gen, povm1, truth, N_SHOTS))
    kron_core.kron_estimate_lin(counts, povm1, n)  # warm
    lin = timed("lin_ms", lambda: kron_core.kron_estimate_lin(counts, povm1, n))
    mle = timed("mle60_ms",
                lambda: kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=MLE_ITERS))
    out["lin_hs"] = float(bootstrap_core._distance_batch("hs", lin, truth, n))
    out["mle_hs"] = float(bootstrap_core._distance_batch("hs", mle, truth, n))
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["counts_shape"] = list(counts.shape)
    return out


def phase7_kron(card):
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.tomography import kron_core

    log("[7] the kron-factored path on the card")
    _kron_dense_checks()

    tmg = qtt.StateTomograph(qtt.GHZ(6), key=6)  # the default device, float32
    tmg.experiment(N_SHOTS, "proj-set")
    if not (tmg.kron_mode and tmg.povm_matrix is None and tmg.results.shape == (729, 64)):
        raise AssertionError("StateTomograph(GHZ(6)) with proj-set is not in kron mode")
    hs = {}
    for method in ("lin", "mle-rhor"):
        hs[method] = float(qtt.hs_dst(tmg.point_estimate(method), tmg.state))
    log(f"    StateTomograph(GHZ(6)), proj-set, {N_SHOTS} shots: kron mode, counts "
        f"{tmg.results.shape}; hs to the truth: lin {hs['lin']:.4e}, mle-rhor "
        f"{hs['mle-rhor']:.4e}")
    if not (math.isfinite(hs["lin"]) and 0 <= hs["mle-rhor"] < TRUTH_HS_LIMIT):
        raise AssertionError(f"6-qubit point estimates off the truth: {hs}")
    est6 = tmg.reconstructed_state

    n_points = 256
    _reset_launches()
    audit = DeviceAudit()
    with audit:
        interval = qtt.BootstrapStateInterval(
            tmg, n_points=n_points, method="mle", max_iter=MLE_ITERS, key=61, state=est6
        )
        interval()
        torch.cuda.synchronize()
    median = _check_distances(interval.distances, n_points, "the 6-qubit bootstrap")
    log(f"    6-qubit BootstrapStateInterval('mle', {n_points}, RrhoR-{MLE_ITERS}): median hs "
        f"{median:.4e}")
    _check_no_kernel_and_on_card(audit, "the 6-qubit bootstrap")

    dev, dtype = tmg.device, tmg.dtype
    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(60)
    b6 = est6.bloch_tensor(dev, dtype)

    def run6():
        return kron_core.kron_bootstrap_distances(
            gen, b6, povm1, 6, N_SHOTS, n_points=n_points, method="mle", max_iter=MLE_ITERS)

    ms = cuda_ms(run6, 3)
    log(f"    6-qubit bootstrap ('mle', {n_points} resamples, RrhoR-{MLE_ITERS}): best of 3 "
        f"{ms:.3f} ms = {n_points / ms * 1e3:.1f} resamples/s on {card}")
    log_idle_share("the 6-qubit bootstrap call", run6, ms)

    rows = {}
    for n in KRON_SCALING:
        truth = qtt.GHZ(n).bloch_tensor(dev, dtype)
        gen.manual_seed(100 + n)
        rows[n] = row = _scaling_row(n, povm1, truth, gen)
        log(f"    scaling n={n} counts {tuple(row['counts_shape'])}: simulate "
            f"{row['simulate_ms']:.3f} ms, lin {row['lin_ms']:.3f} ms, MLE-{MLE_ITERS} "
            f"{row['mle60_ms']:.3f} ms; hs to the truth lin {row['lin_hs']:.4e}, MLE "
            f"{row['mle_hs']:.4e}; peak memory {row['peak_mib']:.1f} MiB on {card}")
        if not 0 <= row["mle_hs"] < TRUTH_HS_LIMIT:
            raise AssertionError(
                f"{n}-qubit MLE hs to the truth {row['mle_hs']} (limit {TRUTH_HS_LIMIT})")

    # bench.py's large bootstrap, centred on the lin estimate as there
    n, n_points = KRON_BOOT
    gen.manual_seed(110)
    counts = kron_core.kron_simulate(gen, povm1, qtt.GHZ(n).bloch_tensor(dev, dtype), N_SHOTS)
    center = kron_core.kron_estimate_lin(counts, povm1, n)
    del counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dists = kron_core.kron_bootstrap_distances(
        gen, center, povm1, n, N_SHOTS, n_points=n_points, method="mle", max_iter=MLE_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(dists).all()):
        raise AssertionError(f"{n}-qubit bootstrap distances are not finite")
    log(f"    {n}-qubit bootstrap ('mle', {n_points} resamples, RrhoR-{MLE_ITERS}): "
        f"{seconds:.3f} s = {n_points / seconds:.3f} resamples/s, median hs "
        f"{float(dists.median()):.4e} on {card}")
    log("    scaling rows: " + json.dumps({str(k): v for k, v in rows.items()}))


def _process_small_checks():
    """Phase 8, parts 1-3: the 2-qubit estimators in float64, the card
    against the CPU on one set of counts, and the launch counts of
    method='states'."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.ops.paulis import bloch_to_matrix
    from quantpy_tpu_torch.tomography import process_core, state_core

    f32, f64 = torch.float32, torch.float64
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=81, dtype=f64)  # the default device
    tmg.experiment(PROC_SMALL_SHOTS)
    if tmg.device.type != DEVICE or tmg._design()[0].device.type != DEVICE:
        raise AssertionError(f"ProcessTomograph's default device is not {DEVICE}: {tmg.device}")
    truth = tmg.channel.choi
    nll, seconds = {}, {}
    for method in ("lifp", "states", "dys", "pgdb"):
        t0 = time.perf_counter()
        est = tmg.point_estimate(method)
        seconds[method] = time.perf_counter() - t0
        hs = float(qtt.hs_dst(est.choi, truth))
        nll[method] = float(tmg._nll(est.choi.bloch))
        log(f"    2 qubits float64 {method:6s}: hs to the true Choi {hs:.4e} (limit "
            f"{PROC_SMALL_HS_LIMIT}), NLL {nll[method]:.6f}, {seconds[method]:.2f} s")
        if not est.is_cptp(verbose=False):
            raise AssertionError(f"the 2-qubit '{method}' estimate is not CPTP")
        if not 0 <= hs < PROC_SMALL_HS_LIMIT:
            raise AssertionError(f"the 2-qubit '{method}' estimate lies {hs} from the truth")
    rel = abs(nll["dys"] - nll["pgdb"]) / abs(nll["pgdb"])
    log(f"    'dys' and 'pgdb' likelihoods: relative difference {rel:.3e} "
        f"(limit {PROC_NLL_REL:.0e})")
    if not rel <= PROC_NLL_REL:
        raise AssertionError(f"'dys' and 'pgdb' disagree in NLL: {rel}")

    counts, b, povm, n_meas = tmg._design()
    raw = process_core.estimate_lifp_factored(counts, b, povm, n_meas, cptp=False)
    by_eigh = process_core.cptp_project_bloch(raw, 2000, 1e-14, "eigh")
    by_ns = process_core.cptp_project_bloch(raw, 2000, 1e-14, "ns")
    norm = float(torch.linalg.matrix_norm(bloch_to_matrix(raw, 4)))
    gap = float(torch.linalg.matrix_norm(bloch_to_matrix(by_ns - by_eigh, 4)))
    log(f"    cptp_project_bloch 'ns' against 'eigh': ||delta||_F {gap:.3e}, "
        f"||A||_F {norm:.3e} (limit 1e-5 ||A||)")
    if not gap <= 1e-5 * norm:
        raise AssertionError(f"the Newton-Schulz projection lies {gap} from eigh's")

    # the same functions on the card and on the CPU, on one set of counts
    dec = tmg._decomposed_single_entries
    for dtype, name in ((f64, "float64"), (f32, "float32")):
        host = tuple(x.to("cpu", dtype) for x in (counts, b, povm, n_meas))
        start = process_core.estimate_lifp_factored(*host, cptp=False)

        def run(device):
            c, bb, pv, nm = (x.to(device) for x in host)
            out = {
                "lifp": process_core.estimate_lifp_factored(c, bb, pv, nm, cptp=False),
                "states_to_choi_bloch": process_core.states_to_choi_bloch(
                    state_core.estimate_lin(c, pv, nm), dec),
            }
            for cp in ("eigh", "ns"):
                # one start and a fixed count of iterations for both devices
                out[f"projection {cp}"] = process_core.cptp_project_bloch_host(
                    start.to(device), max_iter=50, chunk=50, cp=cp)
            return out

        on_cpu, on_card = run("cpu"), run(DEVICE)
        for key, value in on_card.items():
            if value.dtype != dtype or value.device.type != DEVICE:
                raise AssertionError(f"{key} returned {value.dtype} on {value.device}")
        errs = {k: float((v.cpu() - on_cpu[k]).abs().max()) for k, v in on_card.items()}
        log(f"    card against CPU, {name}: max|delta| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {TOL[name]:.0e})")
        if not all(math.isfinite(v) and v <= TOL[name] for v in errs.values()):
            raise AssertionError(f"the card disagrees with the CPU in {name}: {errs}")

    # 'states' hands one float32 batch (S, D) of output states to the estimator
    tmg32 = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=83, dtype=f32)
    tmg32.experiment(PROC_SMALL_SHOTS)
    launches = 0
    for est_method, expected in (("mle-rhor", STATES_RHOR_LAUNCHES), ("lin", 0)):
        _reset_launches()
        est = tmg32.point_estimate("states", states_est_method=est_method)
        launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
        hs = float(qtt.hs_dst(est.choi, tmg32.channel.choi))
        log(f"    method='states' with '{est_method}', 2 qubits float32: rhor_mle / "
            f"rhor_mle_flat launches {launched} (expected ({expected}, 0)); hs to the truth "
            f"{hs:.4e}")
        if launched != (expected, 0):
            raise AssertionError(f"'states' with '{est_method}' launched {launched}")
        if not (np.isfinite(hs) and hs < PROC_SMALL_HS_LIMIT):
            raise AssertionError(f"'states' with '{est_method}' lies {hs} from the truth")
        launches += launched[0]

    # the idle share of a small point estimate: one host sync per Dykstra iteration
    tmg.point_estimate("lifp")
    ms = cuda_ms(lambda: tmg.point_estimate("lifp"), 1)
    log_idle_share("2-qubit point_estimate('lifp'), float64", lambda: tmg.point_estimate("lifp"),
                   ms)
    return launches


def _process_flagship(card):
    """Phase 8, part 4: bench.py's 4-qubit process bootstrap on the card."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops import paulis
    from quantpy_tpu_torch.tomography import bootstrap_core, process_core

    n, shots, n_points = PROC_FLAGSHIP
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matrix products are on; the Newton-Schulz chain needs them off")
    t0 = time.perf_counter()
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=7)  # default device, float32
    tmg.experiment(shots)
    t1 = time.perf_counter()
    center = tmg.point_estimate("lifp")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    hs_truth = float(qtt.hs_dst(center.choi, tmg.channel.choi))
    log(f"    ProcessTomograph(depolarizing(0.1, {n})) on {tmg.device} ({tmg.dtype}): "
        f"{len(tmg.tomographs)} inputs, counts {tmg.results.shape}; construction + experiment "
        f"{t1 - t0:.2f} s, point_estimate('lifp') {t2 - t1:.2f} s, CPTP "
        f"{center.is_cptp(atol=1e-3, verbose=False)}, hs to the true Choi {hs_truth:.4e}")
    if tmg.device.type != DEVICE or tmg.dtype != torch.float32:
        raise AssertionError(f"the flagship tomograph runs on {tmg.device} in {tmg.dtype}")
    if not (center.is_cptp(atol=1e-3, verbose=False) and math.isfinite(hs_truth)):
        raise AssertionError("the 4-qubit lifp point estimate is not CPTP to 1e-3")

    _reset_launches()
    audit = DeviceAudit()
    with audit:
        audited = qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=8)
        audited.setup()
        torch.cuda.synchronize()
    _check_no_kernel_and_on_card(audit, "the process bootstrap")
    log(f"    float64 / complex128 operations in it: {sorted(audit.wide) or 'none'}")
    if audit.wide:
        raise AssertionError(f"float64 operations in the float32 bootstrap: {sorted(audit.wide)}")

    # two seeds, each a new interval, timed whole
    quantiles, best_ms = [], math.inf
    levels = (0.5, 0.9)
    for seed in (9, 10):
        interval = qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(interval.setup, 1)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        best_ms = min(best_ms, ms)
        sample = interval.distances
        if sample.shape != (n_points,) or not np.all(np.isfinite(sample)):
            raise AssertionError("process bootstrap distances not finite or of the wrong shape")
        quantiles.append(interval(levels)[0])
        log(f"    BootstrapProcessInterval(lifp + CPTP, {n_points} resamples), seed {seed}: "
            f"{ms:.3f} ms, hs at {levels} {[float(x) for x in quantiles[-1]]}, median "
            f"{float(np.median(sample)):.4e}, peak memory {peak_mib:.1f} MiB")
        if not PROC_MEDIAN_BAND[0] <= float(np.median(sample)) <= PROC_MEDIAN_BAND[1]:
            raise AssertionError(
                f"process bootstrap median {np.median(sample)} outside {PROC_MEDIAN_BAND}")
    spread = float(np.max(np.abs(quantiles[0] - quantiles[1]) / quantiles[1]))
    log(f"    quantiles of the two seeds differ by {spread:.3%} (limit 10%)")
    if not spread <= 0.10:
        raise AssertionError(f"the two seeds' quantiles differ by {spread}")
    log(f"    process bootstrap, {n} qubits x {len(tmg.tomographs)} inputs x 81 POVMs x {shots} "
        f"shots x {n_points} resamples, float32: best of 2 {best_ms:.3f} ms = "
        f"{n_points / best_ms * 1e3:.2f} resamples/s on {card}")

    # the stages of one call, and every resampled Choi matrix
    interval = qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=11, channel=center)
    gen = torch.Generator(device=tmg.device)
    gen.manual_seed(11)
    design = tmg._design()[1:]  # input blochs, POVM, shots
    iters, chunk = 50 if n <= 4 else 100, 50
    counts = interval.simulate(gen)
    raw = process_core.estimate_lifp_factored(counts, *design, cptp=False)
    chois = interval.estimate(counts)
    ref = tmg._tensor(center.choi.bloch)
    stages = {
        "simulate": lambda: interval.simulate(gen),
        "raw_lifp": lambda: process_core.estimate_lifp_factored(counts, *design, cptp=False),
        "ns_dykstra_projection": lambda: process_core.cptp_project_bloch_host(
            raw, max_iter=iters, chunk=chunk, cp="ns"),
        "distance": lambda: bootstrap_core._distance_batch("hs", chois, ref, 2 * n),
    }
    times = {name: cuda_ms(fn, 2) for name, fn in stages.items()}
    dim = 4**n
    tflop = 39 * 8 * dim**3 * iters * n_points / 1e12  # 2 x 19 sign-chain products + 1 for |A|
    rate = tflop / times["ns_dykstra_projection"] * 1e3
    log("    stages (ms, best of 2): " + json.dumps({k: round(v, 3) for k, v in times.items()}))
    log(f"    NS-Dykstra projection: {tflop:.2f} TFLOP of complex {dim}-dim products in "
        f"{times['ns_dykstra_projection']:.3f} ms = {rate:.2f} TFLOP/s "
        f"({rate * 1e12 / PEAK_FLOPS['float32']:.3f} of the {PEAK_FLOPS['float32'] / 1e12:.0f} "
        f"TFLOP/s float32 peak) on {card}")
    if chois.dtype != torch.float32 or chois.device.type != DEVICE:
        raise AssertionError(f"the projection returned {chois.dtype} on {chois.device}")
    mats = paulis.bloch_to_matrix(chois, 2 * n)
    eye = torch.eye(2**n, dtype=mats.dtype, device=mats.device)
    tp_err = float(torch.linalg.matrix_norm(paulis.ptrace(mats, range(n)) - eye).max())
    min_eig = float(torch.linalg.eigvalsh(mats[:8].to(torch.complex128)).min())
    log(f"    resampled Choi matrices: max ||Tr_out C - I||_F {tp_err:.3e} (limit "
        f"{PROC_TP_TOL:.0e}) over {n_points}; least eigenvalue of the first 8 {min_eig:.3e} "
        f"(limit {PROC_MIN_EIG:.0e})")
    if not tp_err <= PROC_TP_TOL:
        raise AssertionError(f"a resampled Choi matrix is off TP by {tp_err}")
    if not min_eig >= PROC_MIN_EIG:
        raise AssertionError(f"a resampled Choi matrix has eigenvalue {min_eig}")

    def call():
        qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=12, channel=center).setup()

    log_idle_share("the process bootstrap call", call, best_ms)


def _process_eigh_row(card):
    """Phase 8, part 5: a bootstrap on the 'eigh' engine (the default below
    4 qubits), one batched eigh per Dykstra iteration; time and peak memory
    only."""
    import numpy as np

    import quantpy_tpu_torch as qtt

    n, shots, n_points = PROC_EIGH_ROW
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=5)
    tmg.experiment(shots)
    ms_point = cuda_ms(lambda: tmg.point_estimate("lifp"), 1)
    interval = qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(interval.setup, 1)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if not np.all(np.isfinite(interval.distances)):
        raise AssertionError(f"{n}-qubit process bootstrap distances are not finite")
    log(f"    {n}-qubit process bootstrap on the 'eigh' engine ({n_points} resamples, {shots} "
        f"shots, up to 2000 Dykstra iterations of a batched {4**n}-dim eigh): "
        f"point_estimate('lifp') {ms_point:.1f} ms, bootstrap {ms:.1f} ms = "
        f"{n_points / ms * 1e3:.3f} resamples/s, median hs "
        f"{float(np.median(interval.distances)):.4e}, peak memory {peak_mib:.1f} MiB on {card}")


def phase8_process(card):
    log("[8] process tomography on the card")
    launches = _process_small_checks()
    _process_flagship(card)
    _process_eigh_row(card)
    return launches


def _interval_twins(tmg):
    """A float64 CPU tomograph holding `tmg`'s design and counts (a process
    twin keeps the single-qubit design factors)."""
    from quantpy_tpu_torch import interop

    arrays = interop.to_numpy(tmg)
    if hasattr(tmg, "channel"):
        twin = interop.process_tomograph_from_arrays(**arrays, device="cpu", dtype=torch.float64)
        twin._states1_t, twin._povm1 = tmg._states1_t, tmg._povm1
        return twin
    return interop.tomograph_from_arrays(**arrays, device="cpu", dtype=torch.float64)


def _agree(what, card_vals, cpu_vals, rtol=0.0, atol=0.0):
    """Raise unless the card's values equal the CPU's to rtol / atol."""
    import numpy as np

    a = np.asarray(card_vals, dtype=np.float64)
    b = np.asarray(cpu_vals, dtype=np.float64)
    err = float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b) + 1e-300)))
    log(f"    {what}: card vs CPU max |diff| {float(np.max(np.abs(a - b))):.3e} "
        f"({'rtol' if rtol else 'atol'} {rtol or atol:.0e})")
    if not err <= 1.0:
        raise AssertionError(f"{what}: the card and the CPU disagree ({a} vs {b})")


def _analytic_small_checks():
    """Phase 9, part (a): every interval of the slice on 2-qubit tomographs
    in float64, the card against the CPU on the same counts."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.tomography import interval as interval_mod
    from quantpy_tpu_torch.tomography.polytopes import utils, verification

    f64 = torch.float64
    levels = np.linspace(0.1, 0.95, 12)
    state = qtt.StateTomograph(qtt.GHZ(2), key=91, dtype=f64)  # the default device
    state.experiment(3000, "proj-set")
    dephase = qtt.ProcessTomograph(qtt.dephasing(0.3), key=92, dtype=f64)
    dephase.experiment(3000, "proj-set")
    depol = qtt.ProcessTomograph(qtt.depolarizing(0.3, 2), key=93, dtype=f64)
    depol.experiment(3000, "proj-set")
    if not all(t.device.type == DEVICE for t in (state, dephase, depol)):
        raise AssertionError("the phase-9 tomographs are not on the card")

    def radii(cls, tmg, **kw):
        return cls(tmg, **kw)(levels)[0]

    def bands(cls, tmg, **kw):
        iv = cls(tmg, **kw)
        (lo, hi), _ = iv(levels)
        return np.concatenate([lo, hi]), getattr(iv, "lp_iterations", None)

    for name, tmg in (("GHZ(2)", state), ("dephasing(0.3)", dephase),
                      ("depolarizing(0.3, 2)", depol)):
        twin = _interval_twins(tmg)
        for distr in ("gamma", "norm", "exp"):
            _agree(f"MomentInterval('{distr}') of {name}",
                   radii(qtt.MomentInterval, tmg, distr_type=distr),
                   radii(qtt.MomentInterval, twin, distr_type=distr), rtol=1e-10)
        if tmg is state:
            _agree("SugiyamaInterval of GHZ(2)", radii(qtt.SugiyamaInterval, tmg),
                   radii(qtt.SugiyamaInterval, twin), rtol=1e-10)
            _agree("MomentFidelityStateInterval of GHZ(2)",
                   bands(qtt.MomentFidelityStateInterval, tmg, target_state=qtt.GHZ(2))[0],
                   bands(qtt.MomentFidelityStateInterval, twin, target_state=qtt.GHZ(2))[0],
                   rtol=1e-10)
            polys = [("PolytopeStateInterval of GHZ(2)", qtt.PolytopeStateInterval, None)]
        else:
            _agree(f"MomentFidelityProcessInterval of {name}",
                   bands(qtt.MomentFidelityProcessInterval, tmg)[0],
                   bands(qtt.MomentFidelityProcessInterval, twin)[0], rtol=1e-10)
            for kind in ("moment", "sugiyama"):
                _agree(f"HolderInterval('{kind}') of {name}",
                       radii(qtt.HolderInterval, tmg, kind=kind, n_points=64),
                       radii(qtt.HolderInterval, twin, kind=kind, n_points=64), rtol=1e-10)
            # the process polytope on the dense LP, then forced onto the
            # two-factor operator
            polys = [(f"PolytopeProcessInterval (dense) of {name}",
                      qtt.PolytopeProcessInterval, None),
                     (f"PolytopeProcessInterval (two-factor) of {name}",
                      qtt.PolytopeProcessInterval, 1)] if tmg is dephase else []
        for what, cls, dense_max in polys:
            saved = interval_mod._PolytopeBase.DENSE_LP_MAX_ELEMENTS
            interval_mod._PolytopeBase.DENSE_LP_MAX_ELEMENTS = dense_max or saved
            try:
                (card_b, card_it), (cpu_b, cpu_it) = (
                    bands(cls, t, n_points=20) for t in (tmg, twin))
            finally:
                interval_mod._PolytopeBase.DENSE_LP_MAX_ELEMENTS = saved
            _agree(f"{what}, lp_iterations {card_it}", card_b, cpu_b, atol=1e-8)
            if card_it != cpu_it:
                raise AssertionError(f"{what}: lp_iterations {card_it} on the card, {cpu_it} "
                                     "on the CPU")

    freq = np.clip(state.results / state.n_measurements[:, None], 1e-15, 1 - 1e-15)
    targets = np.array([0.0, 0.3, 0.9, 1 - 1e-7])
    _agree("count_delta of GHZ(2)",
           utils.count_delta(targets, state._tensor(freq), state.n_measurements).cpu(),
           utils.count_delta(targets, torch.as_tensor(freq), state.n_measurements), rtol=1e-12)
    problem = verification.qst_problem(qtt.GHZ(2), 500)
    batch = verification.simulate_frequencies(
        torch.Generator().manual_seed(94), *problem[:2], torch.as_tensor(problem[2]), 300)
    cov_levels = np.linspace(0.05, 0.99, 18)
    hits = [verification.coverage_of(f, problem[1], *problem[3:5], cov_levels, problem[5])
            for f in (batch.to(DEVICE), batch)]
    log(f"    coverage_of GHZ(2), 300 trials x 18 levels: hits {hits[0].tolist()}")
    if not np.array_equal(*hits):
        raise AssertionError(f"coverage hits differ: card {hits[0]}, CPU {hits[1]}")


class LPRecorder:
    """Inside it, every PDHG solve of convex/lp.py is recorded: its forward
    map, right-hand sides, objective and tolerance, and its final iterate's
    objective values, violations, iterations and residual readings
    [primal, dual, gap, scale] (the batch maxima the stopping rule reads)."""

    def __enter__(self):
        from quantpy_tpu_torch.convex import lp

        self.solves = []
        self._lp, self._saved = lp, (lp._pdhg, lp._residuals)
        pdhg, residuals = self._saved
        last = {}

        def recording_residuals(*args):
            out = residuals(*args)
            last["stats"] = out[2]
            return out

        def recording_pdhg(fwd, adj, c, b, tau, sigma, n_iter, tol):
            x, obj, viol, iters = pdhg(fwd, adj, c, b, tau, sigma, n_iter, tol)
            self.solves.append({
                "fwd": fwd, "b": b, "c": c, "obj": obj, "viol": viol, "iters": iters,
                "stats": last["stats"].tolist(),
                "tol": lp._default_tol(b.dtype) if tol is None else tol,
            })
            return x, obj, viol, iters

        lp._pdhg, lp._residuals = recording_pdhg, recording_residuals
        return self

    def __exit__(self, *exc):
        self._lp._pdhg, self._lp._residuals = self._saved
        return False


def _row(what, build, card, lp_cap=None):
    """One full-width row of phase 9, part (b): `build()` makes and sets
    up the row's intervals and returns {name: (interval, seconds)}. A first
    call runs under DeviceAudit, with every polytope's LP capped at
    `lp_cap` iterations; the second is timed and read. Returns the second
    call's intervals and its recorded LP solves (LPRecorder)."""
    from quantpy_tpu_torch.tomography import interval as interval_mod

    _reset_launches()
    audit = DeviceAudit()
    saved = interval_mod._PolytopeBase.LP_ITERS
    interval_mod._PolytopeBase.LP_ITERS = lp_cap or saved
    try:
        with audit:
            build()
            torch.cuda.synchronize()
    finally:
        interval_mod._PolytopeBase.LP_ITERS = saved
    _check_no_kernel_and_on_card(audit, what)
    log(f"    float64 / complex128 operations in it: {sorted(audit.wide) or 'none'}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with LPRecorder() as recorder:
        built = build()
    log(f"    {what}: peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB on {card}")
    return built, recorder.solves


def _timed_setup(iv):
    """Set `iv` up; its wall time in seconds (ends in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iv.setup()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _read_lp(name, solves):
    """Print a polytope's min and max LP solves as the stopping rule last
    read them, count the margins that report the 1.0 marker, and check the
    other margins against the true point (see LP_FLAG_VIOL)."""
    low, high = solves
    for label, sv in (("min", low), ("max", high)):
        res_p, res_d, gap, scale = sv["stats"]
        rel = (res_p / (1.0 + float(sv["b"].abs().amax())),
               res_d / (1.0 + float(sv["c"].abs().amax())), gap / scale)
        verdict = "converged" if max(rel) <= sv["tol"] else "NOT converged"
        log(f"        {label} LP: {sv['iters']} iterations, {verdict}: residuals primal "
            f"{rel[0]:.3e}, dual {rel[1]:.3e}, gap {rel[2]:.3e} (each relative, tol "
            f"{sv['tol']:.0e}); max violation {float(sv['viol'].amax()):.3e}")
    flagged = (low["viol"] > LP_FLAG_VIOL) | (high["viol"] > LP_FLAG_VIOL)
    x0 = low["c"]
    value = float(x0 @ x0)
    inside = (low["fwd"](x0.expand(low["b"].shape[0], -1)) - low["b"]).amax(-1) <= 0
    checked = inside & ~flagged
    slack = TRUE_POINT_SLACK * (1.0 + abs(value))
    brackets = (low["obj"] <= value + slack) & (-high["obj"] >= value - slack)
    n_checked, n_wrong = int(checked.sum()), int((checked & ~brackets).sum())
    log(f"        {int(flagged.sum())} of {flagged.numel()} margins report the 1.0 marker "
        f"(violation over {LP_FLAG_VIOL:.0e}); the true point lies in {int(inside.sum())} "
        f"margins' polytopes, and {n_checked - n_wrong} of the {n_checked} unflagged ones "
        f"bracket its objective {value:.6f}")
    if n_checked == 0 or n_wrong:
        raise AssertionError(f"{name}: {n_wrong} of {n_checked} checked margins do not bracket "
                             "the true point's objective")


def _read(name, iv, seconds, banded=False, solves=None):
    """Print an interval's values at ANALYTIC_LEVELS and check them: finite,
    non-negative and non-decreasing radii; bands with min <= max; LP
    iterations within the cap, and a polytope's recorded `solves` through
    _read_lp."""
    import numpy as np

    out, _ = iv(np.asarray(ANALYTIC_LEVELS))
    extra = ""
    if banded:
        lo, hi = (np.asarray(x, dtype=np.float64) for x in out)
        text = f"bounds {[(round(float(a), 6), round(float(b), 6)) for a, b in zip(lo, hi)]}"
        slack = 1e-6 if hasattr(iv, "lp_iterations") else 1e-9
        ok = np.all(np.isfinite(lo)) and np.all(np.isfinite(hi)) and np.all(lo <= hi + slack)
    else:
        dist = np.asarray(out, dtype=np.float64)
        text = f"radii {[round(float(d), 6) for d in dist]}"
        ok = np.all(np.isfinite(dist)) and np.all(dist >= 0) and np.all(np.diff(dist) >= -1e-9)
    if hasattr(iv, "lp_iterations"):
        extra = f", lp_iterations {iv.lp_iterations}"
        ok = ok and max(iv.lp_iterations) <= iv.LP_ITERS
    log(f"      {name}: {seconds * 1e3:.3f} ms, {text} at cl {ANALYTIC_LEVELS}{extra}")
    if not ok:
        raise AssertionError(f"{name}: values fail the interval checks")
    if hasattr(iv, "lp_iterations"):
        _read_lp(name, solves)


def _lp_rate(iv, seconds, macs_per_iteration):
    """Print the PDHG products' rate: 2 MACs-to-FLOPs per counted MAC over
    every iteration of both directions, against the whole setup's time."""
    tflop = 2.0 * macs_per_iteration * sum(iv.lp_iterations) / 1e12
    log(f"      PDHG products {tflop:.3f} TFLOP over {sum(iv.lp_iterations)} iterations in "
        f"{seconds * 1e3:.3f} ms = {tflop / seconds:.3f} TFLOP/s (a lower bound: the setup's "
        "time includes the margins and the host work)")


def _lp_device_split(what, make):
    """Print the idle share of a polytope interval's setup with its LP
    capped at IDLE_LP_ITERS iterations (every PDHG iteration runs the same
    operations), and the share of the card's busy time spent in GEMM
    kernels (kernel names holding "gemm"), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    def capped():
        iv = make()
        iv.LP_ITERS = IDLE_LP_ITERS
        iv.setup()

    wall_ms = cuda_ms(capped, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        capped()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    gemm = sum(e.self_device_time_total for e in events if "gemm" in e.key.lower()) / 1e3
    log(f"    {what}, LP capped at {IDLE_LP_ITERS} iterations: device busy {busy:.3f} ms of a "
        f"{wall_ms:.3f} ms call, idle share {idle_share(busy, wall_ms)}; GEMM kernels "
        f"{gemm:.3f} ms, other kernels {busy - gemm:.3f} ms")


def _analytic_state_rows(card):
    """Phase 9, part (b): the dense GHZ-4 row, the f32-vs-f64 polytope
    check, and the kron GHZ-6 row."""
    import numpy as np

    import quantpy_tpu_torch as qtt

    n, shots, n_points = ANALYTIC_STATE
    tmg = qtt.StateTomograph(qtt.GHZ(n), key=95)  # the default device, float32
    tmg.experiment(shots, "proj-set")
    if tmg.povm_matrix is None or tmg.device.type != DEVICE or tmg.dtype != torch.float32:
        raise AssertionError("the dense state row is not a float32 dense design on the card")

    def build_dense():
        out = {}
        for distr in ("gamma", "norm", "exp"):
            iv = qtt.MomentInterval(tmg, distr_type=distr)
            out[f"MomentInterval('{distr}')"] = (iv, _timed_setup(iv))
        iv = qtt.MomentFidelityStateInterval(tmg, target_state=tmg.state)
        out["MomentFidelityStateInterval"] = (iv, _timed_setup(iv))
        iv = qtt.SugiyamaInterval(tmg)
        out["SugiyamaInterval"] = (iv, _timed_setup(iv))
        iv = qtt.PolytopeStateInterval(tmg, n_points=n_points)
        out["PolytopeStateInterval"] = (iv, _timed_setup(iv))
        return out

    m, p, dim = tmg.povm_matrix.shape
    log(f"    state, dense: GHZ({n}), proj-set ({m} x {p}, K = {m * p}), {shots} shots, "
        f"float32; polytope {n_points} margins x 2 directions of {m * p} constraints x "
        f"{dim - 1} variables")
    rows, solves = _row(f"the dense GHZ-{n} row", build_dense, card, lp_cap=AUDIT_LP_ITERS)
    for name, (iv, seconds) in rows.items():
        _read(name, iv, seconds, banded=name.startswith(("MomentFidelity", "Polytope")),
              solves=solves)
    poly, poly_s = rows["PolytopeStateInterval"]
    _lp_rate(poly, poly_s, 2 * n_points * m * p * (dim - 1))

    _lp_device_split(f"the GHZ-{n} polytope interval",
                     lambda: qtt.PolytopeStateInterval(tmg, n_points=n_points))

    # float32 against float64 on the same counts at the JAX package's
    # test size (test_polytope_interval_f32_vs_x64)
    from quantpy_tpu_torch import interop

    twin64 = interop.tomograph_from_arrays(**interop.to_numpy(tmg), dtype=torch.float64)
    cl = np.linspace(0.3, 0.9, 6)
    got = {}
    for label, t in (("float32", tmg), ("float64", twin64)):
        iv = qtt.PolytopeStateInterval(t, n_points=ANALYTIC_F64_POINTS)
        seconds = _timed_setup(iv)
        (lo, hi), _ = iv(cl)
        got[label] = np.concatenate([lo, hi])
        log(f"      PolytopeStateInterval(n_points={ANALYTIC_F64_POINTS}) in {label}: "
            f"{seconds * 1e3:.3f} ms, lp_iterations {iv.lp_iterations}")
        if max(iv.lp_iterations) > iv.LP_ITERS:
            raise AssertionError(f"{label} polytope LP ran past its cap")
    gap = float(np.max(np.abs(got["float32"] - got["float64"])))
    log(f"      float32 vs float64 bounds at 6 levels in [0.3, 0.9]: max |diff| {gap:.3e} "
        f"(limit {F32_F64_ATOL:.0e})")
    if not gap <= F32_F64_ATOL:
        raise AssertionError(f"float32 polytope bounds lie {gap} from float64's")

    n, shots, n_points = ANALYTIC_KRON
    tmg = qtt.StateTomograph(qtt.GHZ(n), key=96)
    tmg.experiment(shots, "proj-set")
    if not tmg.kron_mode:
        raise AssertionError(f"StateTomograph(GHZ({n})) is not in kron mode")

    def build_kron():
        out = {}
        iv = qtt.MomentInterval(tmg)
        out["MomentInterval (kron_l2_moments)"] = (iv, _timed_setup(iv))
        iv = qtt.SugiyamaInterval(tmg)
        out["SugiyamaInterval (kron_sugiyama_c_alpha)"] = (iv, _timed_setup(iv))
        iv = qtt.MomentFidelityStateInterval(tmg, target_state=tmg.state)
        out["MomentFidelityStateInterval"] = (iv, _timed_setup(iv))
        iv = qtt.PolytopeStateInterval(tmg, n_points=n_points)
        out["PolytopeStateInterval (solve_lp_batch_kron)"] = (iv, _timed_setup(iv))
        return out

    shape = tmg.results.shape
    log(f"    state, kron: GHZ({n}) in kron mode, counts {shape}, {shots} shots, float32; "
        f"polytope {n_points} margins of {shape[0] * shape[1]} constraints x {4**n - 1} "
        "variables")
    rows, solves = _row(f"the kron GHZ-{n} row", build_kron, card, lp_cap=AUDIT_LP_ITERS)
    for name, (iv, seconds) in rows.items():
        _read(name, iv, seconds, banded=name.startswith(("MomentFidelity", "Polytope")),
              solves=solves)
    _lp_device_split(f"the kron GHZ-{n} polytope interval",
                     lambda: qtt.PolytopeStateInterval(tmg, n_points=n_points))


def _analytic_channel_rows(card):
    """Phase 9, part (b): the 4-qubit channel row and its stochastic twin."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.tomography import interval as interval_mod

    n, shots, n_points = ANALYTIC_CHANNEL
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=97)  # default device, float32
    tmg.experiment(shots)
    t0 = tmg.tomographs[0]
    n_in, (m, p, _) = len(tmg.tomographs), t0.povm_matrix.shape
    dim = 4**n

    def build():
        out = {}
        iv = qtt.MomentInterval(tmg)
        out["MomentInterval (per-state Grams)"] = (iv, _timed_setup(iv))
        iv = qtt.MomentFidelityProcessInterval(tmg)
        out["MomentFidelityProcessInterval"] = (iv, _timed_setup(iv))
        for kind in ("moment", "sugiyama"):
            iv = qtt.HolderInterval(tmg, kind=kind)
            out[f"HolderInterval('{kind}'), {n_in} children"] = (iv, _timed_setup(iv))
        iv = qtt.PolytopeProcessInterval(tmg, n_points=n_points)
        out["PolytopeProcessInterval (solve_lp_batch_factors)"] = (iv, _timed_setup(iv))
        return out

    log(f"    channel: depolarizing(0.1, {n}), {n_in} proj4 inputs, proj-set ({m} x {p}), "
        f"{shots} shots, float32; polytope {n_points} margins of ({n_in} x {m * p}) "
        f"constraints x {dim * (dim - 1)} variables, two-factor")
    rows, solves = _row(f"the {n}-qubit channel row", build, card, lp_cap=AUDIT_LP_ITERS)
    for name, (iv, seconds) in rows.items():
        _read(name, iv, seconds, banded=name.startswith(("MomentFidelity", "Polytope")),
              solves=solves)
    poly, poly_s = rows["PolytopeProcessInterval (solve_lp_batch_factors)"]
    # per iteration: forward left-first and adjoint right-first, each
    # P S A B + P S B K MACs
    _lp_rate(poly, poly_s, 2 * n_points * n_in * (dim - 1) * (dim + m * p))
    _lp_device_split(f"the {n}-qubit process polytope interval",
                     lambda: qtt.PolytopeProcessInterval(tmg, n_points=n_points))
    exact = rows["MomentInterval (per-state Grams)"][0]

    def build_stochastic():
        iv = qtt.MomentInterval(tmg)
        return {"MomentInterval (channel_l2_moments_kron, 128 probes)": (iv, _timed_setup(iv))}

    saved = interval_mod._CHANNEL_EXACT_GRAM_MAX
    interval_mod._CHANNEL_EXACT_GRAM_MAX = 1
    try:
        stochastic, _ = _row(f"the {n}-qubit stochastic channel row", build_stochastic, card)
    finally:
        interval_mod._CHANNEL_EXACT_GRAM_MAX = saved
    (name, (iv, seconds)), = stochastic.items()
    _read(name, iv, seconds)
    mean_rel = abs(iv.mean - exact.mean) / abs(exact.mean)
    var_rel = abs(iv.variance - exact.variance) / abs(exact.variance)
    log(f"      against the exact row: mean {mean_rel:.3e} (limit {STOCH_MEAN_REL:.0e}), "
        f"variance {var_rel:.3e} (limit {STOCH_VAR_REL:.0%}) relative")
    if not (mean_rel <= STOCH_MEAN_REL and var_rel <= STOCH_VAR_REL):
        raise AssertionError("the stochastic channel moments are off the exact ones")


def _coverage_rows(card):
    """Phase 9, part (c): the coverage harness at the paper's fig. 1 sizes."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.tomography.polytopes.verification import test_qpt, test_qst

    levels = np.linspace(0.05, 0.99, 18)
    n, shots, trials = COVERAGE_QST
    n_ch, shots_ch, trials_ch = COVERAGE_QPT
    runs = (
        (f"test_qst(GHZ({n}))", trials,
         lambda t: test_qst(qtt.GHZ(n), levels, n_measurements=shots, n_trials=t, key=98)),
        (f"test_qpt(depolarizing(0.1, {n_ch}), 'sic')", trials_ch,
         lambda t: test_qpt(qtt.depolarizing(0.1, n_ch), levels, n_measurements=shots_ch,
                            n_trials=t, input_states="sic", key=99)),
    )
    for what, n_trials, run in runs:
        # audited at a tenth of the trials: each chunk of trials runs the
        # same operations
        _reset_launches()
        audit = DeviceAudit()
        with audit:
            run(n_trials // 10)
            torch.cuda.synchronize()
        _check_no_kernel_and_on_card(audit, what)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cov = run(n_trials)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"    {what}, 18 levels in [0.05, 0.99], {n_trials} trials: {seconds:.3f} s = "
            f"{n_trials / seconds:.1f} trials/s, peak memory {peak:.1f} MiB on {card}")
        log(f"      coverage {[round(float(c), 4) for c in cov]}")
        if not (np.all(cov >= levels - 0.05) and np.all(np.diff(cov) >= -0.05)):
            raise AssertionError(f"{what}: coverage under its levels or falling: {cov}")


def phase9_intervals(card):
    log("[9] the analytic confidence intervals on the card")
    t0 = time.perf_counter()
    _analytic_small_checks()
    _analytic_state_rows(card)
    _analytic_channel_rows(card)
    _coverage_rows(card)
    log(f"    phase 9: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    card = phase0_device()
    log(card)
    sys.path.insert(0, str(REPO))
    phase1_build()
    measured = phase2_kernel_vs_plain()
    tmg, est, launches = phase3_main_path(card)
    phase4_rate(card, tmg, est)
    flat_launches = phase5_flat_path(card, tmg, est)
    phase6_cholesky_mle(card)
    phase7_kron(card)
    launches += phase8_process(card)
    phase9_intervals(card)
    sources = {
        "rhor_mle": ("quantpy_tpu/ops/kernels.py:289", launches),
        "rhor_mle_flat": ("quantpy_tpu/ops/kernels.py:206", flat_launches),
    }
    kernels_line = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"quantpy_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": n_launches,
            **measured[name],
        }
        for name, (replaces, n_launches) in sources.items()
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
