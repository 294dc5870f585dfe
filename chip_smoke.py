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
   moments, Holder's 256 children, the two-factor polytope at 25 margins)
   and its Hutchinson moments; (c) the coverage harness at 10^4 trials x 18
   levels (GHZ-4; 3-qubit QPT with sic inputs).
10. The MCMC intervals on the card (no kernel of their own): (a) at 2
   qubits in float64 the chains' targets (state, process 'bloch', anchored
   kraus, projected) and their autograd drifts, the kraus decodes and 50 MH
   and 50 MALA steps from one set of draws, the card against the CPU;
   float32 rows, each audited for devices, kernel launches (none) and
   float64 operations (only those of the anchored NLL's reduction): (b)
   MHMCStateInterval on phase 3's GHZ-4 experiment (8 chains, adapted);
   (c) bayesian_mean_estimate on it; (d) the 3-qubit process posterior of
   examples/posterior_sampling.py (anchored kraus-MALA, 4 chains), its
   decoded samples checked TP and PSD, beside a 400-resample bootstrap; (e)
   phase 8's 4-qubit experiment: a short anchored kraus-MALA chain and 10
   projected-target MALA steps; (f) HolderInterval('mhmc') at 2 qubits;
   (g) the calibration harness with interval='mhmc'. Each row prints its
   time, steps per second, acceptance, R-hat, ESS, radii and peak memory,
   and the idle share of a span of its chain.
11. The user entry points on the card (rhor_mle through the f32 bootstrap
   batches, never rhor_mle_flat): (a) the state CLI
   (`quantpy_tpu_torch.cli.state_interval.main`) on phase 3's GHZ-4
   experiment written as a JSON record, --method mle-rhor with the
   16,384-resample bootstrap (one rhor_mle launch), the moment, Sugiyama
   and 500-margin polytope intervals, and `python -m
   quantpy_tpu_torch.cli.state_interval --no-ci` in a process of its own;
   (b) a GHZ-6 kron-mode record (moment, 256-resample bootstrap); (c) the
   process CLI on phase 8's 4-qubit experiment (lifp; moment, 256-resample
   bootstrap); each invocation with its host time (parse, validation,
   tomograph), a counted run and an audited rerun (the bootstraps
   profiled for the device's busy time); (d) every deterministic output of
   both CLIs on examples/data's records, the card against the CPU in
   float64 (1e-10 of scale, equal lp_iterations) and float32 against
   float64 (5e-3); (e) resumable_bootstrap (16,384 resamples in chunks of
   4,096, one launch each) interrupted after 2 chunks and resumed, equal to
   the uninterrupted run, the StageTimer report of (a)-(c) and a
   utils.trace() of one bootstrap call that names the kernel; (f) the
   examples at reduced sizes, figures off, each timed, then rerun under
   the device audit (its MCMC chains and 'pgdb' loops shortened). Every
   counted run resets the kernels' counts before it and reads them after.
12. The mesh layer (`quantpy_tpu_torch.parallel`) on MESH_SHARDS logical
   shards of the one card, float32 unless stated: (a) phase 3's GHZ-4
   bootstrap, 16,384 resamples with RrhoR-60, over 4 shards (one rhor_mle
   launch per shard, counted) and over 1, equal to the shards'
   single-device calls on the shards' generators, the rates beside phase
   4's single call, the 4-shard call's idle share; (b) the 6-qubit
   operator-sharded functions against kron_core in float64, then GHZ-12
   with proj-set (8.7 GB of counts): the operator-sharded simulate, lin
   and MLE-60 with times, peak memory and hs to the truth, then the
   single-device kron_core MLE-60 on the gathered counts, its peak and its
   gap to the sharded estimate (11 qubits where 12 do not fit, said so);
   (c) MHMCStateInterval on phase 3's experiment and the anchored kraus
   chains of depolarizing(0.2, 1), 8 chains over 4 shards, against their
   local runs; (d) phase 8's process bootstrap (256 resamples) and phase
   9's GHZ-4 coverage (10^4 trials) over 4 shards and over 1, the coverage
   hits equal to the per-shard coverage_hits; (e)
   quantpy_tpu_torch.examples.multichip, counted, then audited for
   devices.
13. The port's benchmark and entry points: (a)
   `quantpy_tpu_torch.bench.main` in-process at full width, its stderr
   shown and its JSON line printed and checked: every extras key,
   `skipped` empty, `value` within BENCH_RATE_REL of phase 4's rate,
   `mfu_f32_pct` equal to 1.353 TFLOP over the best call and the card's
   FP32 peak, the 6-11 qubit MLE rows within TRUTH_HS_LIMIT of the truth,
   and the rhor_mle and rhor_mle_flat launches equal to those its code
   implies; (b) `quantpy_tpu_torch.entry.entry()`'s flagship round (256
   resamples, RrhoR-100: one rhor_mle launch); (c)
   `entry.dryrun_multichip` over MESH_SHARDS logical shards of the card
   under the device audit, with its rhor_mle launches. Each counted run
   resets the kernels' counts before it and reads them after.
14. The rest of the surface, float32 unless stated: (a) phase 3's 16,384 x
   81 x 16 flagship counts drawn by the chain sampler
   (`sample_multinomial(..., method="chain")`) and by the binary split from
   one set of probabilities, each draw timed (best of 3) with exact row
   totals, each estimated by estimate_lin and RrhoR-60 (one rhor_mle launch
   each, counted, under the device audit) and held to phase 3's median
   band, the two medians within CHAIN_MEDIAN_REL, and B1 held to its plain
   version on the chain's counts (HS_TOL_F32); (b) GHZ-12, proj-set, 10^4
   shots: `kron_simulate` and `kron_simulate_chunked` (27 blocks), each
   timed with its peak memory, exact row totals and per-outcome sums within
   5 standard errors of each other and of n p, then at 8 qubits the
   one-block chunked draw equal to `kron_simulate` bit for bit on a
   reseeded generator; (c) phase 9's 4-qubit channel design through
   `channel_l2_moments_kron` at state_chunk 64 and 256 on the same 128
   probes, float64, equal to 1e-10 relative, with each one's time and peak;
   (d) `estimate_pgdb_factored_host` at 2 qubits in float64 (15 steps from
   a lifp warm start) against `estimate_pgdb_factored` and against the CPU
   (1e-10); (e) `ops/df32` and `ops/cplx` on 10^6 float32 numbers: two_sum
   and two_prod exact against float64, df_div_ff within 2^-40, sum2f within
   one float32 ulp of the float64 sum, the pair conversions exact. Phases
   3, 5, 8, 11, 12, 13 and 14's counted launches make the kernels line's
   counts.

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
# channel row is phase 8's design with the two-factor polytope at 25 margins.
ANALYTIC_STATE = (4, 10_000, 1000)  # qubits, shots, polytope n_points
ANALYTIC_KRON = (6, 10_000, 200)
ANALYTIC_CHANNEL = (4, 2_000, 25)
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
# Phase 10. The card against the CPU in float64: max |card - cpu| <=
# MCMC_CARD_TOL (1 + max |cpu|), over MCMC_CHAIN_STEPS steps of one set of
# draws. The rows: the MHMC state interval on phase 3's experiment
# (n_points, burn_steps, chains); the 3-qubit process posterior of
# examples/posterior_sampling.py (qubits, shots, n_points, burn_steps,
# chains, thinning) beside a bootstrap of MCMC_BOOT_POINTS resamples; the
# 4-qubit kraus chain on phase 8's experiment (mode_seek, burn_steps,
# n_points); the 4-qubit projected MALA steps; Holder's children (n_points,
# burn_steps). Decoded kraus samples are TP to MCMC_TP_TOL and PSD to
# MCMC_MIN_EIG. Idle shares are read on MCMC_IDLE_STEPS steps of a row's
# chain.
MCMC_CARD_TOL = 1e-10
# The projected target's drift differentiates 100 Newton-Schulz Dykstra
# steps of 19 sign iterations each; the sign iteration's Jacobian grows
# directions of small eigenvalues up to 2.57x per iteration, and so the
# rounding of the two devices' different summation orders: this script
# read 1.3e-10 of the drift's scale on an H100 at 700 W.
MCMC_PROJECTED_DRIFT_TOL = 1e-9
MCMC_SMALL_SHOTS = 2_000
MCMC_CHAIN_STEPS = 50
MCMC_STATE = (1000, 1000, 8)
# (d): n_points cut from 600 and burn_steps from 4,000 to fit the time limit
MCMC_PROCESS = (3, 2_000, 200, 250, 4, 8)
MCMC_BOOT_POINTS = 400
MCMC_FOUR = (250, 100, 100)
MCMC_PROJECTED_STEPS = 5
MCMC_HOLDER = (100, 100)
MCMC_TP_TOL = 1e-5
MCMC_MIN_EIG = -1e-6
MCMC_IDLE_STEPS = 20
# each row's audit pass runs these options (shorter chains, the same code)
MCMC_AUDIT_STATE = dict(n_points=16, burn_steps=8, adapt_step=False)
MCMC_AUDIT_BME = dict(n_samples=4, burn_steps=4, adapt_step=False)
MCMC_AUDIT_PROCESS = dict(n_points=8, burn_steps=8, adapt_step=False, thinning=1,
                          mode_seek=5, curv_probes=2)
MCMC_AUDIT_FOUR = dict(n_points=4, burn_steps=2, mode_seek=5, curv_probes=2)

# phase 11: the user entry points (the CLIs, the utilities, the examples)
CLI_STATE = (16_384, 500)  # phase 3's GHZ-4 record: bootstrap resamples, polytope margins
CLI_KRON = (6, 10_000, 256)  # qubits, shots, bootstrap resamples
CLI_PROCESS_POINTS = 256  # bootstrap resamples on phase 8's 4-qubit record
CLI_LEVELS = [0.5, 0.9, 0.99]
CLI_CARD_TOL = 1e-10  # card vs CPU in float64, relative to the output's scale
CLI_F32_TOL = 5e-3  # float32 vs float64 on the card (the polytope's F32_F64_ATOL)
RESUME = (16_384, 4_096, 2)  # points, chunk size, chunks before the interruption
B1_PER_F32_BATCH = 1  # rhor_mle launches of one float32 'mle-rhor' batch on the card
EXAMPLE_BOOT = 128
EXAMPLE_REPEATS = 3
EXAMPLE_MAX_QUBITS = 6
EXAMPLE_QUALITY_REPEATS = 50
EXAMPLE_POSTERIOR = dict(n_qubits=1, n_shots=500, n_points=40, burn_steps=100, n_boot=60)
# phase 12: the mesh layer, MESH_SHARDS logical shards on the one card
MESH_SHARDS = 4
MESH_BOOT_POINTS = N_POINTS
MESH_KRON = (12, 11)  # qubits of the operator-sharded row; the second if the first does not fit
MESH_CHECK_QUBITS = 6  # the float64 equalities against kron_core
MESH_MATCH_TOL = 1e-5  # sharded vs single-device MLE-60, float32, max |delta bloch|
# the chains share the one card shard after shard, so they are kept short
MESH_STATE_CHAINS = dict(n_points=400, burn_steps=300, n_chains=8)
MESH_KRAUS_CHAINS = dict(n_points=160, burn_steps=100, n_chains=8, mode_seek=100,
                         curv_probes=8)
MESH_STATE_REL = 0.3  # the tolerances of tests/test_parallel.py
MESH_KRAUS_REL = 0.7
MESH_PROCESS = (256, 50)  # resamples, NS-Dykstra iterations
MESH_COVERAGE_EXACT = 1_000
# phase 13: the port's benchmark and entry points. The bench's extras
# are bench.py's keys (bench.py:181-187, 200, 214, 268, 294, 306, 324, 353)
# less mfu_exposed_pct, and the twin's own four.
BENCH_KEYS = (
    "mfu_f32_pct", "tflops", "mle_iters", "n_points", "state_lin_6q_ms",
    "state_boot_6q_mle_rec_s", "state_scaling_kron", "state_boot_10q_mle_rec_s",
    "kernel_lane_rec_s", "kernel_flat_rec_s", "process_boot_4q_rec_s",
    "skipped", "times_ms", "spread", "device",
)
BENCH_RATE_REL = 0.15  # the bench's value against phase 4's rate of the same call
# mfu_f32_pct is rounded to 0.1 and the call times to 1 us
BENCH_MFU_ROUNDING = 0.05 + 1e-3
ENTRY_POINTS = 256  # resamples of entry()'s bootstrap round
# phase 14: the rest of the surface
CHAIN_SEED = 1414  # the generator of (a)'s two draws
CHAIN_MEDIAN_REL = 0.05  # chain-sampled median hs against the binary split's
SURFACE_KRON = (12, 8)  # qubits of (b)'s fused / chunked draws; of its one-block equality
SURFACE_CHANNEL = (4, 2_000, (64, 256), 128)  # qubits, shots, state chunks, probes
SURFACE_CHANNEL_REL = 1e-10  # the two state chunkings, float64, relative
SURFACE_PGDB = (2, 10_000, 15, 300)  # qubits, shots, pgd iterations, Dykstra iterations
SURFACE_PGDB_TOL = 1e-10  # host loop against the fused call, and the card against the CPU
SURFACE_DF32_N = 1_000_000  # random float32 numbers of (e)
SURFACE_DF32_REL = 2.0**-40  # df_div_ff's (hi, lo) against the float64 quotient


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

    from quantpy_tpu_torch.bench import flat_kernel_on_main_path
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
    with audit:
        # audited at a tenth of the iterations: each L-BFGS iteration runs
        # the same operations, and the audit's dispatch costs ~25 s at 100
        qtt.BootstrapStateInterval(
            tmg, n_points=n_points, method="mle", max_iter=max_iter // 10, key=6, state=est
        )()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    interval = qtt.BootstrapStateInterval(
        tmg, n_points=n_points, method="mle", max_iter=max_iter, key=6, state=est
    )
    dists, _ = interval((0.5, 0.9, 0.99))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    median = _check_distances(interval.distances, n_points, "'mle' bootstrap")
    log(f"    BootstrapStateInterval('mle', {n_points} resamples, max_iter {max_iter}): hs at "
        f"(0.5, 0.9, 0.99) {[float(x) for x in dists]}; median {median:.4e}; first run "
        f"{wall:.2f} s (the audited pass: max_iter {max_iter // 10})")
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

    ms = cuda_ms(call, 2)
    log(f"    bootstrap_distances('mle'), {n_points} resamples, max_iter {max_iter}: best of 2 "
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
    return tmg


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
    tmg = _process_flagship(card)
    _process_eigh_row(card)
    return launches, tmg


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


# -- phase 10: the MCMC intervals -----------------------------------------------


class StepCounter:
    """Counts the steps of every device chain run while it is active, by
    wrapping `mhmc._run_chain`: `steps` the loop's iterations, `chain_steps`
    those times the chains side by side."""

    def __init__(self):
        self.steps = self.chain_steps = 0

    def __enter__(self):
        from quantpy_tpu_torch import mhmc

        self._run_chain = run_chain = mhmc._run_chain

        def counted(gen, x0, *args, **kwargs):
            n_steps = int(args[4])
            self.steps += n_steps
            self.chain_steps += n_steps * max(1, x0[..., 0].numel())
            return run_chain(gen, x0, *args, **kwargs)

        mhmc._run_chain = counted
        return self

    def __exit__(self, *exc):
        from quantpy_tpu_torch import mhmc

        mhmc._run_chain = self._run_chain


def _close(what, card_vals, cpu_vals, tol=MCMC_CARD_TOL):
    """Raise unless max |card - cpu| <= tol (1 + max |cpu|)."""
    a = torch.as_tensor(card_vals).detach().cpu().double()
    b = torch.as_tensor(cpu_vals).detach().cpu().double()
    err = float((a - b).abs().max())
    scale = 1.0 + float(b.abs().max())
    log(f"    {what}: card vs CPU max |diff| {err:.3e} (limit {tol:.0e} x {scale:.3e})")
    if not err <= tol * scale:
        raise AssertionError(f"{what}: the card and the CPU disagree by {err}")


def _mcmc_targets(tmg_state, tmg_process):
    """The chains' targets of the 2-qubit tomographs: name -> (target,
    start)."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops.cholesky import np_matrix_to_real_tril_vec

    mat = tmg_state.reconstructed_state.matrix + 1e-7 * np.eye(4)
    total = float(np.sum(tmg_state.n_measurements))
    targets = {"state (Cholesky, count-weighted)": (
        lambda x: -total * tmg_state._nll(x),
        np_matrix_to_real_tril_vec(mat / np.trace(mat).real))}
    choi = np.asarray(tmg_process.reconstructed_channel.choi.bloch)
    targets["process 'bloch'"] = (lambda y: -tmg_process._nll(y), choi)
    for name, options in (("process kraus anchored, whitened",
                           dict(parametrization="kraus", proposal="mala")),
                          ("process projected (NS Dykstra 100, K-FAC whitened)",
                           dict(proposal="mala"))):
        iv = qtt.MHMCProcessInterval(tmg_process, mode_seek=0, curv_probes=0, **options)
        iv.channel = tmg_process.reconstructed_channel
        if options.get("parametrization") == "kraus":
            targets[name] = iv._kraus_target(choi, 1.0)
        else:
            targets[name] = iv._projected_target(choi, 1.0)
    return targets


def _mcmc_small_checks():
    """Phase 10, part (a): the chains' pieces at 2 qubits in float64, the
    card against the CPU on the same inputs."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch import mhmc
    from quantpy_tpu_torch.tomography import process_core

    f64 = torch.float64
    st = qtt.StateTomograph(qtt.GHZ(2), key=101, dtype=f64)
    st.experiment(N_SHOTS, "proj-set")
    st.point_estimate("lin")
    pt = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=102, dtype=f64)
    pt.experiment(MCMC_SMALL_SHOTS)
    pt.point_estimate("lifp")
    twins = _interval_twins(st), _interval_twins(pt)
    twins[0].reconstructed_state = st.reconstructed_state
    twins[1].reconstructed_channel = pt.reconstructed_channel
    on_card, on_cpu = _mcmc_targets(st, pt), _mcmc_targets(*twins)
    rng = np.random.default_rng(10)
    for name, (target, start) in on_card.items():
        cpu_target, cpu_start = on_cpu[name]
        start = np.asarray(torch.as_tensor(start).cpu(), dtype=np.float64)
        xs = start + 1e-3 * rng.normal(size=(3,) + start.shape)
        values, drifts = mhmc._value_and_grad(target, torch.as_tensor(xs, device=DEVICE))
        cpu_values, cpu_drifts = mhmc._value_and_grad(cpu_target, torch.as_tensor(xs))
        if values.device.type != DEVICE:
            raise AssertionError(f"the {name} target ran on {values.device}")
        _close(f"{name} target", values, cpu_values)
        _close(f"{name} autograd drift", drifts, cpu_drifts,
               MCMC_PROJECTED_DRIFT_TOL if name.startswith("process projected") else MCMC_CARD_TOL)

    # the kraus decodes and the anchor pack's exact-delta decode
    d = 16
    y0 = process_core.np_kraus_param_from_choi_bloch(pt.reconstructed_channel.choi.bloch)
    ys = y0 + 0.05 * rng.normal(size=(4, 2, d, d))
    a_l, a_r, a_l_inv, a_r_inv = process_core.kraus_design_whitener(
        pt._input_blochs_t(), twins[1]._nll_operands()[1].numpy(),
        np.concatenate([t.flat_results for t in pt.tomographs]),
        pt.reconstructed_channel.choi.bloch)
    pack, x_ref = process_core.np_kraus_anchor_pack(a_l_inv @ (y0[0] + 1j * y0[1]) @ a_r_inv,
                                                    a_l, a_r)
    dz = np.concatenate([1e-3 * rng.normal(size=(3, 2, d, d)), rng.normal(size=(1, 2, d, d))])
    for name, fn, arg in (
        ("kraus_param_to_choi_bloch", process_core.kraus_param_to_choi_bloch, ys),
        ("kraus_param_to_choi_bloch_whitened",
         lambda y: process_core.kraus_param_to_choi_bloch_whitened(y, a_l, a_r), ys),
        ("kraus_delta_choi_bloch (both branches)",
         lambda z: process_core.kraus_delta_choi_bloch(z, pack), dz),
    ):
        _close(name, fn(torch.as_tensor(arg, device=DEVICE)), fn(torch.as_tensor(arg)))

    # 50 MH and 50 MALA steps from one set of draws
    for name, use_mala, step in (("state (Cholesky, count-weighted)", False, 1e-3),
                                 ("process kraus anchored, whitened", True, 2e-3)):
        finals, counts = [], []
        for targets, device in ((on_card, DEVICE), (on_cpu, "cpu")):
            target, start = targets[name]
            x = torch.as_tensor(np.asarray(torch.as_tensor(start).cpu()), device=device)
            draws = np.random.default_rng(11)
            deltas = torch.as_tensor(draws.normal(size=(MCMC_CHAIN_STEPS,) + tuple(x.shape)),
                                     device=device)
            log_us = torch.log(torch.as_tensor(draws.uniform(size=MCMC_CHAIN_STEPS),
                                               device=device))
            drift_fn = mhmc.autograd_drift(target)
            logp, drift = mhmc._value_and_drift(target, drift_fn, x)
            states, accepted = [], 0
            for delta, log_u in zip(deltas, log_us):
                if use_mala:
                    x, logp, drift, acc = mhmc.mala_step(x, logp, drift, delta, log_u, target,
                                                         drift_fn, step)
                else:
                    x, logp, acc = mhmc.mh_step(x, logp, delta, log_u, target,
                                                mhmc.normalized_update, step)
                states.append(x)
                accepted += int(acc)
            finals.append(torch.stack(states))
            counts.append(accepted)
        kind = "MALA" if use_mala else "MH"
        log(f"    {MCMC_CHAIN_STEPS} {kind} steps of the {name} target from one set of draws: "
            f"accepted {counts[0]} on the card, {counts[1]} on the CPU")
        if counts[0] != counts[1]:
            raise AssertionError(f"the {kind} chains accepted {counts} steps")
        _close(f"{kind} chain states", finals[0], finals[1])


def _allowed_wide_ops():
    """The float64 operations of the float32 anchored NLL's reduction
    (forward and backward), the only ones a float32 row may run."""
    from quantpy_tpu_torch.tomography import process_core

    dp = torch.full((2, 8), 1e-3, device=DEVICE, requires_grad=True)
    counts = torch.ones(8, dtype=torch.float64, device=DEVICE)
    audit = DeviceAudit()
    with audit:
        value = process_core._rel_nll_from_dp(dp, counts, counts / 8)
        torch.autograd.grad(value.sum(), dp)
    return audit.wide


def _audited(what, run, allowed, **small):
    """Run `run(**small)`, a short pass of a row, under the device audit:
    no kernel launch, nothing off the card and no float64 operation outside
    `allowed`. Then run the row itself, `run()`, unaudited (the audit's
    Python dispatch would slow it): no kernel launch. Returns run()'s value,
    its wall time in seconds and its StepCounter; the peak memory counts
    from its start."""
    _reset_launches()
    audit = DeviceAudit()
    with audit:
        run(**small)
        torch.cuda.synchronize()
    _check_no_kernel_and_on_card(audit, f"{what}, audit pass {small}")
    extra = sorted(audit.wide - allowed)
    log(f"    float64 / complex128 operations in it: {sorted(audit.wide) or 'none'}")
    if extra:
        raise AssertionError(f"{what}: float64 operations outside the NLL's reduction: {extra}")
    _reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepCounter() as counter:
        out = run()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    from quantpy_tpu_torch.ops import kernels

    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    log(f"    {what}: rhor_mle / rhor_mle_flat launches {launched} (the unaudited run)")
    if launched != (0, 0):
        raise AssertionError(f"{what} launched an RrhoR kernel: {launched}")
    return out, seconds, counter


def _span_idle_share(what, chain, x, n_steps=None):
    """The idle share of `n_steps` (default MCMC_IDLE_STEPS) steps of
    `chain` from the states x."""
    n_steps = n_steps or MCMC_IDLE_STEPS
    chain._run_span(x, n_steps)  # warm
    wall = cuda_ms(lambda: chain._run_span(x, n_steps), 1)
    log_idle_share(f"{what}, {n_steps} steps of {max(1, x[..., 0].numel())} chains", lambda:
                   chain._run_span(x, n_steps), wall)
    return wall / n_steps


def _print_chain_row(name, iv, seconds, counter, card, levels=(0.5, 0.9)):
    import numpy as np

    dist, _ = iv(np.asarray(levels))
    if not (np.all(np.isfinite(dist)) and np.all(np.diff(dist) >= 0)):
        raise AssertionError(f"{name}: distances {dist} not finite and non-decreasing")
    log(f"      {name}: {seconds:.3f} s, {counter.steps} steps ({counter.chain_steps} chain-steps) "
        f"= {counter.steps / seconds:.1f} steps/s ({counter.chain_steps / seconds:.1f} "
        f"chain-steps/s); acceptance {iv.acceptance_rate:.4f}, step {iv.chain.step:.4g}; R-hat "
        f"{iv.r_hat:.4f}, ESS {iv.ess:.1f}; d50/d90 {[round(float(v), 6) for v in dist]}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB on {card}")
    return dist


def _mcmc_state_rows(card, tmg, est, allowed):
    """Phase 10, parts (b) and (c): the MHMC state interval and the Bayesian
    mean on phase 3's GHZ-4 experiment."""
    import quantpy_tpu_torch as qtt

    n_points, burn, n_chains = MCMC_STATE
    tmg.reconstructed_state = est

    def state_interval(n_points=n_points, burn_steps=burn, adapt_step=True):
        return _setup(qtt.MHMCStateInterval(
            tmg, n_points=n_points, burn_steps=burn_steps, adapt_step=adapt_step,
            n_chains=n_chains, key=31))

    iv, seconds, counter = _audited("MHMCStateInterval", state_interval, allowed,
                                    **MCMC_AUDIT_STATE)
    log(f"    (b) MHMCStateInterval on GHZ({N_QUBITS}), proj-set, {N_SHOTS} shots, float32: "
        f"n_points {n_points}, burn_steps {burn}, adapt_step, {n_chains} chains")
    _print_chain_row("MHMCStateInterval", iv, seconds, counter, card)
    x = iv.chain.x_t.expand(n_chains, -1).clone()
    ms = _span_idle_share("the state chain", iv.chain, x)
    log(f"      one step of {n_chains} chains: {ms:.3f} ms")

    def bme(**small):
        return qtt.bayesian_mean_estimate(tmg, key=32, **small)

    (rho, radius, diag), seconds, counter = _audited("bayesian_mean_estimate", bme, allowed,
                                                     **MCMC_AUDIT_BME)
    hs_bme = float(qtt.hs_dst(rho, tmg.state))
    hs_rhor = float(qtt.hs_dst(est, tmg.state))
    log(f"    (c) bayesian_mean_estimate (8 chains x 500 samples, thinning 2, burn 500, adapt): "
        f"{seconds:.3f} s, {counter.steps} steps ({counter.chain_steps} chain-steps); acceptance "
        f"{diag['acceptance_rate']:.4f}, step {diag['step']:.4g}; credible radius (0.9) "
        f"{radius:.6f}; hs to the true state: posterior mean {hs_bme:.6f}, RrhoR estimate "
        f"{hs_rhor:.6f}")
    if not (rho.is_density_matrix(verbose=False) and 0 < radius < 1 and hs_bme < 0.1):
        raise AssertionError(f"the posterior mean is off: radius {radius}, hs {hs_bme}")


def _setup(iv):
    iv.setup()
    return iv


def _check_cptp_samples(what, mats):
    import numpy as np

    mats = np.asarray(mats)
    d = mats.shape[-1]
    d_in = int(round(math.sqrt(d)))
    tr_out = np.einsum("sibjb->sij", mats.reshape(-1, d_in, d_in, d_in, d_in))
    tp_err = float(np.abs(tr_out - np.eye(d_in)).max())
    min_eig = float(np.linalg.eigvalsh(mats).min())
    log(f"      {what}: {mats.shape[0]} decoded samples, max |Tr_out C - I| {tp_err:.3e} (limit "
        f"{MCMC_TP_TOL:.0e}), least eigenvalue {min_eig:.3e} (limit {MCMC_MIN_EIG:.0e})")
    if not (tp_err <= MCMC_TP_TOL and min_eig >= MCMC_MIN_EIG):
        raise AssertionError(f"{what}: a decoded sample is not CPTP")


def _mcmc_process_rows(card, tmg4, allowed):
    """Phase 10, parts (d) and (e): the 3-qubit process posterior and the
    4-qubit rows."""
    import warnings

    import numpy as np

    import quantpy_tpu_torch as qtt

    n, shots, n_points, burn, n_chains, thinning = MCMC_PROCESS
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.15, n), key=5)  # default device, float32
    tmg.experiment(shots, "proj-set")
    tmg.point_estimate("lifp")

    def posterior(**small):
        options = dict(n_points=n_points, burn_steps=burn, adapt_step=True, thinning=thinning)
        options.update(small)
        out = qtt.MHMCProcessInterval(
            tmg, step=0.01, parametrization="kraus", proposal="mala", n_chains=n_chains,
            return_samples=True, key=7, **options)
        return out, out.setup()[3]

    (iv, samples), seconds, counter = _audited(f"the {n}-qubit kraus-MALA interval",
                                               posterior, allowed, **MCMC_AUDIT_PROCESS)
    log(f"    (d) MHMCProcessInterval, depolarizing(0.15, {n}), proj-set, {shots} shots, "
        f"float32: anchored kraus-MALA, whitened, mode_seek 500, 32 curvature probes, "
        f"{n_chains} chains, thinning {thinning}, {n_points} points, burn {burn} (the example's "
        "600 points and 4,000 burn-in steps cut to fit phase 10's time), adapt")
    dist = _print_chain_row("kraus-MALA", iv, seconds, counter, card)
    _check_cptp_samples("kraus-MALA", samples)
    boot = qtt.BootstrapProcessInterval(tmg, n_points=MCMC_BOOT_POINTS, key=8, cp_engine="ns")
    boot_dist, _ = boot(np.array([0.5, 0.9]))
    log(f"      beside BootstrapProcessInterval({MCMC_BOOT_POINTS} resamples, the 'ns' engine) d50/d90 "
        f"{[round(float(v), 6) for v in boot_dist]}; chain / bootstrap "
        f"{[round(float(a / b), 4) for a, b in zip(dist, boot_dist)]}")
    x = iv.chain.x_t.expand(n_chains, -1).clone()
    ms = _span_idle_share("the 3-qubit kraus-MALA chain", iv.chain, x)
    log(f"      one step of {n_chains} chains: {ms:.3f} ms")

    n4 = tmg4.channel.n_qubits
    seek, burn4, points4 = MCMC_FOUR

    def four(n_points=points4, burn_steps=burn4, mode_seek=seek, curv_probes=32):
        return _setup(qtt.MHMCProcessInterval(
            tmg4, n_points=n_points, burn_steps=burn_steps, parametrization="kraus",
            proposal="mala", mode_seek=mode_seek, curv_probes=curv_probes, key=9))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        iv4, seconds, counter = _audited(f"the {n4}-qubit kraus-MALA chain", four, allowed,
                                         **MCMC_AUDIT_FOUR)
    fired = any(issubclass(w.category, RuntimeWarning) and "NOT converged" in str(w.message)
                and f"R-hat {iv4.r_hat:.2f}" in str(w.message) for w in caught)
    log(f"    (e) {n4} qubits, depolarizing(0.1, {n4}), {len(tmg4.tomographs)} inputs, proj-set, "
        f"2000 shots, float32: anchored kraus-MALA, mode_seek {seek}, burn {burn4}, "
        f"{points4} points, 1 chain, no adaptation")
    _print_chain_row("kraus-MALA", iv4, seconds, counter, card)
    log(f"      {seconds / counter.steps * 1e3:.3f} ms per step (mode seeking and the curvature "
        f"probes included); the non-convergence RuntimeWarning fired: {fired}")
    ms = _span_idle_share(f"the {n4}-qubit kraus-MALA chain", iv4.chain, iv4.chain.x_t)
    log(f"      one step: {ms:.3f} ms")
    _anchored_rounding_field(iv4)

    def projected(n_points=MCMC_PROJECTED_STEPS):
        return _setup(qtt.MHMCProcessInterval(tmg4, n_points=n_points, burn_steps=0,
                                              proposal="mala", step=1e-3, key=10))

    iv4b, seconds, counter = _audited(f"the {n4}-qubit projected 'bloch' MALA chain",
                                      projected, allowed, n_points=1)
    log(f"      projected-target 'bloch' MALA (K-FAC whitened, NS Dykstra 100 with autograd), "
        f"{counter.steps} steps: {seconds:.3f} s = {seconds / counter.steps * 1e3:.1f} ms per "
        f"step with the setup and the reported projections; acceptance "
        f"{iv4b.acceptance_rate:.3f}; peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"MiB on {card}")


def _anchored_rounding_field(iv):
    """The float32 anchored target against its float64 evaluation on the
    same anchor and offsets: the chain's state dz and 15 offsets around it
    that raise the NLL by O(10^2). The spread is the rounding field the chain's
    acceptance ratios see."""
    import numpy as np

    from quantpy_tpu_torch.tomography import process_core

    pack, x_ref = iv._kraus_anchor
    b, w, flat = iv._design_arrays()
    d1 = b.shape[-1]
    p_ref = d1 * (b @ x_ref.reshape(d1, d1) @ w.T).reshape(-1)
    # the chain runs in u = dz / s, unit curvature per coordinate by the
    # Hutchinson diagonal; offsets s N(0, 1) / sqrt(dim) raise the NLL by
    # O(10^2), the scale of the acceptance ratios near the mode
    scale = iv._kraus_uscale / math.sqrt(iv._kraus_uscale.size)
    dz0 = iv.chain.x_t.double().cpu().numpy() * iv._kraus_uscale
    rng = np.random.default_rng(12)
    pts = dz0 + rng.normal(size=(16, dz0.size)) * scale * np.r_[0.0, np.ones(15)][:, None]
    values = {}
    for dtype in (torch.float32, torch.float64):
        args = [torch.as_tensor(a, dtype=dtype, device=DEVICE) for a in (pts, b, w)]
        values[dtype] = process_core.process_nll_anchored(
            *args, torch.as_tensor(flat, dtype=torch.float64, device=DEVICE), pack,
            torch.as_tensor(p_ref, dtype=torch.float64, device=DEVICE)).double().cpu().numpy()
    gap = np.abs(values[torch.float32] - values[torch.float64])
    log(f"      anchored NLL, float32 decode + float64 reduction against float64 throughout, at "
        f"the chain's state and 15 offsets around it: max |diff| {gap.max():.4e}, rms "
        f"{np.sqrt(np.mean(gap**2)):.4e}; the float64 NLLs span "
        f"[{values[torch.float64].min():.3f}, {values[torch.float64].max():.3f}]")


def _mcmc_holder_and_metrics(card, allowed):
    """Phase 10, parts (f) and (g)."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch import metrics

    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, 2), key=41)  # default device, float32
    tmg.experiment(MCMC_SMALL_SHOTS)
    n_points, burn = MCMC_HOLDER
    # the audit pass runs a 1-qubit channel's 4 children: the same code
    # as the 16 children of the 2-qubit row
    small = qtt.ProcessTomograph(qtt.depolarizing(0.1, 1), key=42)
    small.experiment(MCMC_SMALL_SHOTS)

    def holder(process=tmg, n_points=n_points, burn_steps=burn):
        return _setup(qtt.HolderInterval(process, n_points=n_points, kind="mhmc",
                                         burn_steps=burn_steps))

    iv, seconds, counter = _audited("HolderInterval('mhmc')", holder, allowed, process=small,
                                    n_points=8, burn_steps=8)
    dist, _ = iv(np.asarray(ANALYTIC_LEVELS))
    log(f"    (f) HolderInterval('mhmc'), depolarizing(0.1, 2), {len(tmg.tomographs)} children, "
        f"n_points {n_points}, burn {burn}, float32: {seconds:.3f} s, {counter.steps} steps; "
        f"radii {[round(float(v), 6) for v in dist]} at cl {ANALYTIC_LEVELS}")
    if not (np.all(np.isfinite(dist)) and np.all(dist >= 0) and np.all(np.diff(dist) >= 0)):
        raise AssertionError(f"HolderInterval('mhmc') radii {dist} not finite and monotone")

    def levels_state(n_points=100, burn_steps=100):
        return metrics.get_CL_list_state(qtt.GHZ(2), interval="mhmc", n_iter=2,
                                         n_measurements=1000, n_points=n_points,
                                         burn_steps=burn_steps)

    def levels_channel(n_points=100, burn_steps=100):
        return metrics.get_CL_list_channel(qtt.depolarizing(0.1, 1), interval="mhmc",
                                           n_iter=2, n_measurements=1000, n_points=n_points,
                                           burn_steps=burn_steps, step=0.005)

    for what, run in (("get_CL_list_state(GHZ(2), 'mhmc')", levels_state),
                      ("get_CL_list_channel(depolarizing(0.1, 1), 'mhmc')", levels_channel)):
        levels, seconds, _ = _audited(what, run, allowed, n_points=8, burn_steps=8)
        log(f"    (g) {what}, 2 experiments: {seconds:.3f} s, achieved levels "
            f"{[round(float(v), 4) for v in levels]}")
        if not (levels.shape == (2,) and np.all((levels >= 0) & (levels <= 1))):
            raise AssertionError(f"{what}: levels {levels} outside [0, 1]")


def phase10_mcmc(card, tmg, est, tmg4):
    log("[10] the MCMC intervals on the card")
    t0 = time.perf_counter()
    log("    (a) 2 qubits, float64, the card against the CPU")
    _mcmc_small_checks()
    allowed = _allowed_wide_ops()
    log(f"    float64 operations of the anchored NLL's reduction, the only ones allowed in the "
        f"float32 rows: {sorted(allowed)}")
    log(f"    (a): {time.perf_counter() - t0:.1f} s")
    for part, run in (("(b), (c)", lambda: _mcmc_state_rows(card, tmg, est, allowed)),
                      ("(d), (e)", lambda: _mcmc_process_rows(card, tmg4, allowed)),
                      ("(f), (g)", lambda: _mcmc_holder_and_metrics(card, allowed))):
        t1 = time.perf_counter()
        run()
        log(f"    {part}: {time.perf_counter() - t1:.1f} s")
    log(f"    phase 10: {time.perf_counter() - t0:.1f} s")


def _counted(what, fn, tally, b1=None):
    """Run fn() once as a counted run of phase 11's main path: every kernel's
    count set to 0 just before and read just after. rhor_mle_flat must not
    launch, rhor_mle `b1` times where given. Adds the rhor_mle launches to
    `tally` and returns (fn's value, wall seconds, rhor_mle launches)."""
    from quantpy_tpu_torch.ops import kernels

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b1_n, b2_n = kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches
    tally[0] += b1_n
    if b2_n:
        raise AssertionError(f"{what} launched rhor_mle_flat {b2_n} times")
    if b1 is not None and b1_n != b1:
        raise AssertionError(f"{what} launched rhor_mle {b1_n} times, expected {b1}")
    return out, seconds, b1_n


def _audited_busy_ms(what, fn, profile):
    """fn() once more under the device audit and, with `profile`,
    torch.profiler: raise if an operation ran off DEVICE; return the
    device's busy milliseconds (the audit slows the host, not the card's
    kernels; None unprofiled) and the aten ops seen."""
    audit = DeviceAudit()

    def run():
        with audit:
            fn()
            torch.cuda.synchronize()

    busy = None
    if profile:
        busy = device_busy_ms(run)
    else:
        run()
    if audit.off_device:
        raise AssertionError(f"{what}: operations off {DEVICE}: {sorted(audit.off_device)}")
    return busy, audit.n_ops


def _check_cli_output(what, out, kind, n_levels):
    import numpy as np

    keys = {"state" if kind == "state" else "process", "fidelity_min", "fidelity_max",
            "hs_radius"}
    if set(out) != keys:
        raise AssertionError(f"{what}: output keys {sorted(out)}, expected {sorted(keys)}")
    radius = np.asarray(out["hs_radius"])
    fmin, fmax = np.asarray(out["fidelity_min"]), np.asarray(out["fidelity_max"])
    values = np.concatenate([np.asarray(out[k], dtype=float) for k in keys])
    if not (radius.shape == fmin.shape == fmax.shape == (n_levels,)
            and np.all(np.isfinite(values)) and np.all(radius >= 0)
            and np.all(np.diff(radius) >= 0) and np.all(fmin <= fmax + 1e-6)):
        raise AssertionError(f"{what}: implausible output {out}")


def _cli_invocation(what, module, kind, path, argv, tally, timer, b1, profile=False):
    """One console invocation, `module.main(["-i", path, ...argv])`, on the
    card: the host's share (parsing, validation, the tomograph), the counted
    run timed in `timer`'s stage `what`, its output checked, then an
    audited rerun, profiled with `profile` for the device's busy time.
    Returns the output and the wall seconds."""
    from quantpy_tpu_torch.cli import common

    t0 = time.perf_counter()
    doc = common.load_input(path)
    t1 = time.perf_counter()
    common.validate_record(doc, kind)
    t2 = time.perf_counter()
    module._build_tomograph(doc, DEVICE)
    t3 = time.perf_counter()
    out_path = f"{path}.{what.replace(' ', '_')}.out.json"
    args = ["-i", path, "-o", out_path, "--device", DEVICE] + argv

    def invoke():
        with timer.stage(what):
            module.main(args)

    _, seconds, launched = _counted(what, invoke, tally, b1)
    with open(out_path) as fp:
        out = json.load(fp)
    _check_cli_output(what, out, kind, len(CLI_LEVELS))
    busy, n_ops = _audited_busy_ms(what, lambda: module.main(args), profile)
    device = (f"device busy {busy / 1e3:.3f} s in the audited rerun, idle share "
              f"{idle_share(busy, seconds * 1e3)}" if profile else "the audited rerun unprofiled")
    log(f"    {what}: {seconds:.3f} s (host: parse {t1 - t0:.3f}, validate {t2 - t1:.3f}, "
        f"tomograph {t3 - t2:.3f} s); {device} ({n_ops} aten ops, all on {DEVICE}); "
        f"rhor_mle launches {launched}; hs radii "
        f"{[round(v, 6) for v in out['hs_radius']]}, fidelity band "
        f"[{out['fidelity_min'][-1]:.6f}, {out['fidelity_max'][-1]:.6f}] at "
        f"{CLI_LEVELS[-1]}")
    return out, seconds


def _write_record(path, doc):
    t0 = time.perf_counter()
    with open(path, "w") as fp:
        json.dump(doc, fp)
    log(f"    record {Path(path).name}: {Path(path).stat().st_size / 2**20:.1f} MiB, "
        f"written in {time.perf_counter() - t0:.2f} s")
    return path


def _cli_state_rows(card, tmg, tmp, tally, timer):
    """Phase 11, part (a): the state CLI on phase 3's GHZ-4 record."""
    import numpy as np

    from quantpy_tpu_torch.cli import state_interval

    n_boot, margins = CLI_STATE
    n = tmg.state.n_qubits
    path = _write_record(f"{tmp}/ghz{n}_state.json", {
        "povm_matrix": tmg.povm_matrix.tolist(),
        "outcomes": tmg.results.astype(int).tolist(),
        "target_state": tmg.state.bloch.tolist(),
        "conf_levels": CLI_LEVELS,
    })
    log(f"    (a) state CLI, GHZ({n}), proj-set, {int(tmg.n_measurements[0])} shots, "
        f"--method mle-rhor, float32, on {card}")
    rows = (
        ("bootstrap", ["--interval", "bootstrap", "--n-points", str(n_boot)], B1_PER_F32_BATCH),
        ("moment", ["--interval", "moment"], 0),
        ("sugiyama", ["--interval", "sugiyama"], 0),
        ("polytope", ["--interval", "polytope", "--n-points", str(margins)], 0),
    )
    for what, argv, b1 in rows:
        _cli_invocation(f"state {what}", state_interval, "state", path,
                        ["--method", "mle-rhor"] + argv, tally, timer, b1,
                        profile=what == "bootstrap")
    # the console entry as a user runs it, in a process of its own
    out_path = f"{tmp}/console.out.json"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "quantpy_tpu_torch.cli.state_interval", "-i", path, "-o",
         out_path, "--no-ci", "--device", DEVICE],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"python -m quantpy_tpu_torch.cli.state_interval failed:\n"
                             f"{res.stderr[-2000:]}")
    with open(out_path) as fp:
        console = json.load(fp)["state"]
    here = state_interval.run(state_interval.load_input(path), no_ci=True, device=DEVICE)
    gap = float(np.max(np.abs(np.subtract(console, here["state"]))))
    log(f"    python -m quantpy_tpu_torch.cli.state_interval --no-ci: {seconds:.2f} s in its own "
        f"process (interpreter, imports and the card's start included); its 'lin' state "
        f"against this process's: max |diff| {gap:.3e}")
    if not gap <= 1e-6:
        raise AssertionError(f"the console entry's state differs from run()'s by {gap}")
    return path


def _cli_kron_rows(card, tmp, tally, timer):
    """Phase 11, part (b): the state CLI on a kron-mode record."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.cli import state_interval

    n, shots, n_boot = CLI_KRON
    tmg = qtt.StateTomograph(qtt.GHZ(n), key=611)
    tmg.experiment(shots, "proj-set")
    if not tmg.kron_mode:
        raise AssertionError(f"GHZ({n}) with proj-set did not take kron mode")
    path = _write_record(f"{tmp}/ghz{n}_kron.json", {
        "povm_kron": tmg.povm_kron.tolist(),
        "n_qubits": n,
        "outcomes": tmg.results.astype(int).tolist(),
        "target_state": tmg.state.bloch.tolist(),
        "conf_levels": CLI_LEVELS,
    })
    log(f"    (b) state CLI, kron record GHZ({n}), outcomes {tmg.results.shape}, {shots} shots, "
        "float32")
    for what, argv in (("moment", ["--interval", "moment"]),
                       ("bootstrap", ["--interval", "bootstrap", "--n-points", str(n_boot)])):
        _cli_invocation(f"kron {what}", state_interval, "state", path,
                        ["--method", "mle-rhor"] + argv, tally, timer, 0,
                        profile=what == "bootstrap")


def _cli_process_rows(card, tmg4, tmp, tally, timer):
    """Phase 11, part (c): the process CLI on phase 8's 4-qubit record."""
    from quantpy_tpu_torch.cli import process_interval

    n = tmg4.channel.n_qubits
    path = _write_record(f"{tmp}/process{n}.json", {
        "povm_matrix": tmg4.tomographs[0].povm_matrix.tolist(),
        "input_states": [s.bloch.tolist() for s in tmg4.input_basis.elements],
        "outcomes": tmg4.results.astype(int).tolist(),
        "target_process": tmg4.channel.choi.bloch.tolist(),
        "conf_levels": CLI_LEVELS,
    })
    log(f"    (c) process CLI, {n} qubits, {len(tmg4.tomographs)} inputs, proj-set, "
        f"{int(tmg4.tomographs[0].n_measurements[0])} shots, --method lifp, float32")
    for what, argv in (("moment", ["--interval", "moment"]),
                       ("bootstrap", ["--interval", "bootstrap", "--n-points",
                                      str(CLI_PROCESS_POINTS)])):
        _cli_invocation(f"process {what}", process_interval, "process", path,
                        ["--method", "lifp"] + argv, tally, timer, 0,
                        profile=what == "bootstrap")


@contextlib.contextmanager
def _recorded(module, name):
    """`module.name`, an interval class, replaced by a subclass that keeps
    its instances in the list this yields."""
    made = []
    base = getattr(module, name)

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    setattr(module, name, Recorded)
    try:
        yield made
    finally:
        setattr(module, name, base)


def _cli_outputs(device, dtype):
    """Every deterministic output of the two CLIs on the bundled records, run
    on `device` in `dtype`: {name: values}, and the polytopes'
    lp_iterations."""
    from quantpy_tpu_torch import config
    from quantpy_tpu_torch.cli import common, process_interval, state_interval

    data = REPO / "examples" / "data"
    state_doc = common.load_input(data / "ghz2_state_record.json")
    process_doc = common.load_input(data / "cnot2_process_record.json")
    prev = config.rdtype()
    config.set_dtype(dtype)
    out, iterations = {}, []
    try:
        with _recorded(state_interval, "PolytopeStateInterval") as made:
            for method in ("lin", "mle-rhor"):
                for interval in ("moment", "sugiyama", "polytope"):
                    res = state_interval.run(state_doc, method=method, interval=interval,
                                             device=device)
                    for key, values in res.items():
                        out[f"state {method} {interval} {key}"] = values
            res = process_interval.run(process_doc, interval="moment", device=device)
            for key, values in res.items():
                out[f"process lifp moment {key}"] = values
        iterations = [iv.lp_iterations for iv in made]
    finally:
        config.set_dtype(prev)
    return out, iterations


def _cli_small_checks():
    """Phase 11, part (d): the CLIs' deterministic outputs on the bundled
    2-qubit records, the card against the CPU in float64 and float32
    against float64 on the card."""
    import numpy as np

    audit = DeviceAudit()
    with audit:
        card, card_iters = _cli_outputs(DEVICE, torch.float64)
    if audit.off_device:
        raise AssertionError(f"(d) operations off {DEVICE}: {sorted(audit.off_device)}")
    cpu, cpu_iters = _cli_outputs("cpu", torch.float64)
    worst = max(float(np.max(np.abs(np.subtract(card[k], cpu[k]))))
                / max(1.0, float(np.max(np.abs(cpu[k])))) for k in cpu)
    log(f"    (d) bundled records (GHZ-2 state, CNOT process), {len(cpu)} outputs, float64: "
        f"card vs CPU max |diff| / scale {worst:.3e} "
        f"(limit {CLI_CARD_TOL:.0e}); lp_iterations card {card_iters}, CPU {cpu_iters}")
    if not (set(card) == set(cpu) and worst <= CLI_CARD_TOL and card_iters == cpu_iters):
        raise AssertionError("(d) the CLIs' outputs on the card differ from the CPU's")
    f32, f32_iters = _cli_outputs(DEVICE, torch.float32)
    gaps = {k: float(np.max(np.abs(np.subtract(f32[k], card[k])))) for k in card}
    key = max(gaps, key=gaps.get)
    log(f"    (d) float32 against float64 on the card: max |diff| {gaps[key]:.3e} ({key}; limit "
        f"{CLI_F32_TOL:.0e}); lp_iterations {f32_iters}")
    if not gaps[key] <= CLI_F32_TOL:
        raise AssertionError(f"(d) float32 outputs {gaps[key]} from float64: {key}")


def _utility_rows(card, path, tally, timer, rate_ms):
    """Phase 11, part (e): resumable_bootstrap on (a)'s tomograph, the
    StageTimer report of (a) to (c) and a trace of one bootstrap call."""
    import numpy as np

    from quantpy_tpu_torch.cli import state_interval
    from quantpy_tpu_torch.tomography import bootstrap_core
    from quantpy_tpu_torch.utils import ChunkedAccumulator, resumable_bootstrap, trace

    n_points, chunk, n_before = RESUME
    n_chunks = -(-n_points // chunk)
    tmg = state_interval._build_tomograph(state_interval.load_input(path), DEVICE)
    tmg.point_estimate("mle-rhor", physical=False)  # as the CLI estimates
    tmp = Path(path).parent

    def boot(name, points):
        return resumable_bootstrap(str(tmp / name), tmg, points, chunk_size=chunk,
                                   method="mle-rhor", max_iter=MLE_ITERS, seed=11)

    full, seconds, _ = _counted("the uninterrupted resumable_bootstrap",
                                lambda: boot("full.npz", n_points), tally,
                                n_chunks * B1_PER_F32_BATCH)
    _counted("the interrupted resumable_bootstrap", lambda: boot("resumed.npz", n_before * chunk),
             tally, n_before * B1_PER_F32_BATCH)
    saved = ChunkedAccumulator(str(tmp / "resumed.npz"))
    resumed, _, _ = _counted("the resumed resumable_bootstrap", lambda: boot("resumed.npz", n_points),
                             tally, (n_chunks - n_before) * B1_PER_F32_BATCH)
    gap = float(np.max(np.abs(resumed - full)))
    single = rate_ms / 1e3
    log(f"    (e) resumable_bootstrap, {n_points} resamples of RrhoR-{MLE_ITERS} in chunks of "
        f"{chunk} on (a)'s tomograph: {seconds:.3f} s = {n_points / seconds:.1f} resamples/s "
        f"with {n_chunks} .npz flushes, against phase 4's single call {N_POINTS / single:.1f}/s; "
        f"interrupted after {saved.n_chunks} chunks ({saved.n_done} samples) and resumed: max "
        f"|diff| to the uninterrupted run {gap:.3e}; median {np.median(full):.4e}")
    if not (full.shape == (n_points,) and np.all(np.isfinite(full)) and gap <= 1e-7):
        raise AssertionError(f"the resumed bootstrap differs from the uninterrupted one: {gap}")
    log(f"    StageTimer over (a)-(c), seconds: "
        f"{json.dumps({k: round(v, 4) for k, v in timer.report().items()})}")
    trace_dir = tmp / "trace"
    bloch = tmg._tensor(tmg.reconstructed_state.bloch)
    gen = torch.Generator(device=tmg.device)
    gen.manual_seed(5)
    t0 = time.perf_counter()
    with trace(str(trace_dir), device=DEVICE):
        bootstrap_core.bootstrap_distances(
            gen, bloch, tmg._tensor(tmg.povm_matrix), tmg._tensor(tmg.n_measurements),
            n_points=chunk, method="mle-rhor", max_iter=MLE_ITERS)
    files = list(trace_dir.glob("*.pt.trace.json"))
    text = files[0].read_text() if len(files) == 1 else ""
    named = "rhor_mle_kernel" in text
    log(f"    trace() around one {chunk}-resample bootstrap_distances call: "
        f"{time.perf_counter() - t0:.2f} s, {len(text) / 2**20:.2f} MiB Chrome trace; names "
        f"the rhor_mle kernel: {named}")
    if len(files) != 1 or (B1_PER_F32_BATCH and not named):
        raise AssertionError(f"trace() wrote {files}; the rhor_mle kernel named: {named}")


@contextlib.contextmanager
def _short_loops():
    """The examples' audited reruns: the same code with shorter loops, the
    process chains with phase 10's audit passes (MCMC_AUDIT_PROCESS) and
    'pgdb' with 2 iterations (the audit's Python dispatch would slow the
    full loops several-fold)."""
    import quantpy_tpu_torch as qtt

    chains, estimate = qtt.MHMCProcessInterval, qtt.ProcessTomograph.point_estimate

    class Short(chains):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, **MCMC_AUDIT_PROCESS})

    def short_estimate(self, method="lifp", *args, **kwargs):
        if method == "pgdb":
            kwargs["n_iter"] = 2
        return estimate(self, method, *args, **kwargs)

    qtt.MHMCProcessInterval, qtt.ProcessTomograph.point_estimate = Short, short_estimate
    try:
        yield
    finally:
        qtt.MHMCProcessInterval, qtt.ProcessTomograph.point_estimate = chains, estimate


def _example_rows(card, tally):
    """Phase 11, part (f): the examples at reduced sizes, figures off."""
    import os
    import warnings

    from quantpy_tpu_torch.examples import (
        fidelity_intervals,
        posterior_sampling,
        real_records,
        scaling_study,
        state_tomography,
        teleportation,
    )

    os.environ["EXAMPLES_FIGURES"] = "0"
    device = ["--device", DEVICE]

    def posterior():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # short-chain R-hat
            cd, bd, r_hat, ess = posterior_sampling.process_posterior(**EXAMPLE_POSTERIOR)
        log(f"    chain d50/d90 {cd.round(4)}, bootstrap {bd.round(4)}, R-hat {r_hat:.3f}, "
            f"ESS {ess:.0f}")
        import numpy as np

        if not (np.all(np.isfinite(cd)) and np.all(np.isfinite(bd))
                and cd[0] < 5 * bd[1] and bd[0] < 5 * max(cd[1], 1e-3)):
            raise AssertionError("the posterior and the bootstrap are not on one scale")

    rows = (
        ("teleportation.main", lambda: teleportation.main(device)),
        (f"real_records.main --boot {EXAMPLE_BOOT}",
         lambda: real_records.main(["--boot", str(EXAMPLE_BOOT)] + device)),
        (f"fidelity_intervals.main --repeats {EXAMPLE_REPEATS}",
         lambda: fidelity_intervals.main(["--repeats", str(EXAMPLE_REPEATS)] + device)),
        (f"posterior_sampling.process_posterior({EXAMPLE_POSTERIOR})", posterior),
        (f"state_tomography.main --max-qubits {EXAMPLE_MAX_QUBITS}",
         lambda: state_tomography.main(
             ["--max-qubits", str(EXAMPLE_MAX_QUBITS), "--repeats",
              str(EXAMPLE_QUALITY_REPEATS)] + device)),
        (f"scaling_study.main({EXAMPLE_MAX_QUBITS})",
         lambda: scaling_study.main(EXAMPLE_MAX_QUBITS)),
    )
    log(f"    (f) the examples, figures off, on {card}")
    for what, run in rows:
        _, seconds, launched = _counted(what, run, tally)
        audit = DeviceAudit()
        t0 = time.perf_counter()
        with audit, _short_loops(), contextlib.redirect_stdout(None):
            run()
            torch.cuda.synchronize()
        log(f"    {what}: {seconds:.3f} s; rhor_mle launches {launched}; audited rerun "
            f"{time.perf_counter() - t0:.3f} s, {audit.n_ops} aten ops")
        if audit.off_device:
            raise AssertionError(f"{what}: operations off {DEVICE}: {sorted(audit.off_device)}")


def phase11_entry_points(card, tmg, tmg4, rate_ms):
    """The user entry points on the card; returns the rhor_mle launches of
    its counted runs."""
    import tempfile

    from quantpy_tpu_torch.utils import StageTimer

    log("[11] the user entry points on the card")
    t0 = time.perf_counter()
    tally = [0]
    timer = StageTimer(device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        path = _cli_state_rows(card, tmg, tmp, tally, timer)
        _cli_kron_rows(card, tmp, tally, timer)
        _cli_process_rows(card, tmg4, tmp, tally, timer)
        log(f"    (a)-(c): {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        _cli_small_checks()
        log(f"    (d): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        _utility_rows(card, path, tally, timer, rate_ms)
        log(f"    (e): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    _example_rows(card, tally)
    log(f"    (f): {time.perf_counter() - t1:.1f} s")
    log(f"    phase 11: {time.perf_counter() - t0:.1f} s; rhor_mle launches in its counted runs "
        f"{tally[0]}, rhor_mle_flat none")
    return tally[0]


# -- phase 12: the mesh layer -----------------------------------------------------


def _mesh(k):
    from quantpy_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[DEVICE] * k)


def _mesh_resample_row(card, tmg, est, rate_ms, tally):
    """Phase 12, part (a): phase 3's GHZ-4 bootstrap (RrhoR-60) over
    MESH_SHARDS logical shards on the card and over one shard."""
    from quantpy_tpu_torch.parallel import sharded_bootstrap_distances
    from quantpy_tpu_torch.parallel.mesh import shard_generators
    from quantpy_tpu_torch.tomography import bootstrap_core

    dev, dtype = tmg.device, tmg.dtype
    bloch = est.bloch_tensor(dev, dtype)
    povm = torch.as_tensor(tmg.povm_matrix, dtype=dtype, device=dev)
    n_meas = torch.as_tensor(tmg.n_measurements, dtype=dtype, device=dev)
    n_points, k = MESH_BOOT_POINTS, MESH_SHARDS
    meshes = {k: _mesh(k), 1: _mesh(1)}

    def call(size, key=12):
        return sharded_bootstrap_distances(
            meshes[size], key, bloch, povm, n_meas, n_points, method="mle-rhor",
            max_iter=MLE_ITERS)

    d4, seconds, launched = _counted(f"the {k}-shard bootstrap", lambda: call(k), tally,
                                     b1=k * B1_PER_F32_BATCH)
    if d4.device != meshes[k].devices[0] or d4.dtype != dtype:
        raise AssertionError(f"the sharded distances are {d4.dtype} on {d4.device}")
    median = _check_distances(d4.cpu().numpy(), n_points, f"the {k}-shard bootstrap")
    per = n_points // k
    parts = [
        bootstrap_core.bootstrap_distances(g, bloch, povm, n_meas, per, method="mle-rhor",
                                           max_iter=MLE_ITERS)
        for g in shard_generators(meshes[k], 12)
    ]
    diff = float((d4 - torch.cat(parts)).abs().max())
    log(f"    (a) GHZ-{N_QUBITS} bootstrap, {n_points} resamples over {k} logical shards on "
        f"{card} ({per} per shard), RrhoR-{MLE_ITERS}, float32: first call {seconds:.3f} s, "
        f"rhor_mle launches {launched}; median hs {median:.4e}; against the {k} single-device "
        f"calls on the shards' generators max |diff| {diff:.3e}")
    if diff != 0.0:
        again = bootstrap_core.bootstrap_distances(
            shard_generators(meshes[k], 12)[0], bloch, povm, n_meas, per, method="mle-rhor",
            max_iter=MLE_ITERS)
        rerun = float((again - parts[0]).abs().max())
        log(f"      two identical single-device calls differ by {rerun:.3e}")
        if rerun == 0.0 or diff > HS_TOL_F32:
            raise AssertionError(
                f"the sharded bootstrap differs from its shards' single-device calls by {diff}")
        log("      the single-device program is not deterministic on the card; the shards "
            f"agree within {HS_TOL_F32:.0e}")
    call(k)
    call(1)  # warm
    ms = {size: cuda_ms(lambda size=size: call(size), 3) for size in (k, 1)}
    log(f"    {k} shards: best of 3 {ms[k]:.3f} ms = {n_points / ms[k] * 1e3:.1f} resamples/s; "
        f"1 shard {ms[1]:.3f} ms = {n_points / ms[1] * 1e3:.1f} resamples/s; phase 4's single "
        f"call {rate_ms:.3f} ms = {N_POINTS / rate_ms * 1e3:.1f} resamples/s, on {card}")
    log_idle_share(f"the {k}-shard call", lambda: call(k), ms[k])


def _mesh_operator_checks():
    """The 6-qubit equalities of tests/test_torch_parallel.py on the card in
    float64: the operator-sharded functions against kron_core there."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.parallel import (
        povm_sharded_probabilities,
        sharded_kron_adjoint_flat,
        sharded_kron_estimate_lin,
        sharded_kron_estimate_mle_rhor,
        sharded_kron_forward_flat,
    )
    from quantpy_tpu_torch.tomography import kron_core, state_core

    f64, dev, n = torch.float64, torch.device(DEVICE), MESH_CHECK_QUBITS
    mesh = _mesh(MESH_SHARDS)
    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=f64, device=dev)
    bloch = torch.stack([qtt.GHZ(n).bloch_tensor(dev, f64),
                         qtt.fully_mixed(n).bloch_tensor(dev, f64)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(126)
    counts = kron_core.kron_simulate(gen, povm1, bloch, 1000.0)
    flat = counts.reshape(2, -1)
    povm = torch.as_tensor(qtt.generate_measurement_matrix("proj-set", 4), dtype=f64, device=dev)
    w = state_core.weighted_povm_flat(povm, torch.full((81,), 1000.0, dtype=f64, device=dev))
    b4 = qtt.GHZ(4).bloch_tensor(dev, f64)
    rows = (
        ("forward", sharded_kron_forward_flat(mesh, bloch, povm1, n),
         kron_core.kron_forward_flat(povm1, n, bloch), 0.0, 1e-12),
        ("adjoint", sharded_kron_adjoint_flat(mesh, flat, povm1, n),
         kron_core.kron_adjoint_flat(povm1, n, flat), 1e-12, 1e-15),
        ("lin", sharded_kron_estimate_lin(mesh, counts, povm1, n),
         kron_core.kron_estimate_lin(counts, povm1, n), 1e-10, 1e-13),
        ("MLE-40", sharded_kron_estimate_mle_rhor(mesh, counts, povm1, n, max_iter=40),
         kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=40), 1e-8, 1e-10),
        ("povm_sharded_probabilities", povm_sharded_probabilities(mesh, w, b4), w @ b4, 0.0,
         1e-10),
    )
    for what, got, want, rtol, atol in rows:
        err = float(((got - want).abs() - rtol * want.abs()).max())
        log(f"    {n}-qubit {what} over {MESH_SHARDS} shards vs kron_core, float64 on {DEVICE}: "
            f"max |diff| - rtol |want| {err:.3e} (rtol {rtol:.0e}, atol {atol:.0e})")
        if not (got.device.type == DEVICE and err <= atol):
            raise AssertionError(f"the sharded {what} disagrees with kron_core: {err}")


def _mesh_operator_row(card, n):
    """Phase 12, part (b): GHZ-n, proj-set, N_SHOTS shots per POVM: the
    operator-sharded simulate, lin and MLE-60 over MESH_SHARDS shards, then
    the single-device MLE-60 on the gathered counts."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.parallel import (
        sharded_kron_estimate_lin,
        sharded_kron_estimate_mle_rhor,
        sharded_kron_simulate,
    )
    from quantpy_tpu_torch.tomography import bootstrap_core, kron_core

    dev, f32 = torch.device(DEVICE), torch.float32
    mesh = _mesh(MESH_SHARDS)
    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=f32, device=dev)
    truth = qtt.GHZ(n).bloch_tensor(dev, f32)
    out = {"step": None}

    def timed(name, fn):
        out["step"] = name
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return result

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts = timed("simulate", lambda: sharded_kron_simulate(mesh, 120 + n, povm1, truth,
                                                             N_SHOTS))
    lin = timed("lin", lambda: sharded_kron_estimate_lin(mesh, counts, povm1, n))
    mle = timed("mle", lambda: sharded_kron_estimate_mle_rhor(
        mesh, counts, povm1, n, init_bloch=lin, max_iter=MLE_ITERS))
    n_counts = math.prod(counts.shape)
    shard_shape = tuple(counts.shards[0].shape)
    hs = {k: float(bootstrap_core._distance_batch("hs", v, truth, n))
          for k, v in (("lin", lin), ("mle", mle))}
    gathered = timed("gather", counts.gather)
    del counts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    single = timed("single", lambda: kron_core.kron_estimate_mle_rhor(
        gathered, povm1, n, init_bloch=lin, max_iter=MLE_ITERS))
    del gathered
    gap = float((single - mle).abs().max())
    log(f"    (b) GHZ-{n}, proj-set, {N_SHOTS} shots per POVM, float32, over {MESH_SHARDS} "
        f"logical shards on {card}: counts {n_counts * 4 / 1e9:.2f} GB born split in shards of "
        f"{shard_shape}")
    log(f"      simulate {out['simulate_s']:.3f} s (peak {out['simulate_peak_gib']:.2f} GiB), lin "
        f"{out['lin_s']:.3f} s (peak {out['lin_peak_gib']:.2f} GiB), MLE-{MLE_ITERS} "
        f"{out['mle_s']:.3f} s (peak {out['mle_peak_gib']:.2f} GiB); hs to the truth lin "
        f"{hs['lin']:.4e}, MLE {hs['mle']:.4e}")
    log(f"      gather {out['gather_s']:.3f} s; the single-device kron_core MLE-{MLE_ITERS} on "
        f"the gathered counts {out['single_s']:.3f} s, peak {out['single_peak_gib']:.2f} GiB; "
        f"sharded vs single max |diff| {gap:.3e} (limit {MESH_MATCH_TOL:.0e})")
    if not 0 <= hs["mle"] < TRUTH_HS_LIMIT:
        raise AssertionError(f"{n}-qubit sharded MLE hs to the truth {hs['mle']}")
    if not gap <= MESH_MATCH_TOL:
        raise AssertionError(f"the sharded and single-device {n}-qubit MLE differ by {gap}")


def _mesh_chain_rows(card, tmg, est):
    """Phase 12, part (c): the state chains on phase 3's experiment and the
    anchored kraus chains of a 1-qubit channel, with a mesh and without."""
    import warnings

    import numpy as np

    import quantpy_tpu_torch as qtt

    mesh = _mesh(MESH_SHARDS)
    tmg.reconstructed_state = est
    levels = np.linspace(0.1, 0.9, 5)

    def state(**kw):
        return qtt.MHMCStateInterval(tmg, adapt_step=True, key=41, **MESH_STATE_CHAINS, **kw)

    channel = qtt.ProcessTomograph(qtt.depolarizing(0.2, 1), key=3)  # default device, float32
    channel.experiment(1000, "proj-set")
    channel.point_estimate("lifp")

    def kraus(key, **kw):
        return qtt.MHMCProcessInterval(channel, step=0.05, parametrization="kraus",
                                       adapt_step=True, key=key, **MESH_KRAUS_CHAINS, **kw)

    rows = (
        (f"MHMCStateInterval on GHZ-{N_QUBITS}", state, state, levels, MESH_STATE_REL),
        ("anchored kraus chains, depolarizing(0.2, 1)", lambda **kw: kraus(21, **kw),
         lambda **kw: kraus(22, **kw), np.linspace(0.1, 0.9, 9), MESH_KRAUS_REL),
    )
    for what, sharded, local, cl, rel_limit in rows:
        out = {}
        for name, build in (("mesh", lambda: sharded(mesh=mesh)), ("local", local)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # short-chain R-hat
                iv = build()
                dist, _ = iv(cl)
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0, np.asarray(dist), iv)
        (s_mesh, d_mesh, iv_mesh), (s_local, d_local, _) = out["mesh"], out["local"]
        if what.startswith("MHMC"):
            rel = float(np.max(np.abs(d_mesh - d_local) / d_local))
        else:
            m, m_v = float(np.median(d_mesh)), float(np.median(d_local))
            rel = abs(m - m_v) / max(m, m_v)
        log(f"    (c) {what}, {iv_mesh.n_chains} chains over {MESH_SHARDS} shards: "
            f"{s_mesh:.3f} s (local {s_local:.3f} s); acceptance {iv_mesh.acceptance_rate:.4f}; "
            f"distances {np.round(d_mesh, 6).tolist()} vs local {np.round(d_local, 6).tolist()}; "
            f"relative gap {rel:.4f} (limit {rel_limit})")
        if not (np.all(np.isfinite(d_mesh)) and 0 < iv_mesh.acceptance_rate <= 1
                and rel < rel_limit):
            raise AssertionError(f"{what}: the mesh chains disagree with the local run")


def _mesh_process_and_coverage_rows(card, tmg4):
    """Phase 12, part (d): phase 8's process bootstrap and phase 9's GHZ-4
    coverage, over MESH_SHARDS shards and over one."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.parallel import sharded_coverage, sharded_process_bootstrap_distances
    from quantpy_tpu_torch.parallel.mesh import shard_generators
    from quantpy_tpu_torch.tomography.polytopes import verification

    k = MESH_SHARDS
    meshes = {k: _mesh(k), 1: _mesh(1)}
    center = tmg4.reconstructed_channel
    t0 = tmg4.tomographs[0]
    outs = np.stack([center.transform(s).bloch for s in tmg4.input_basis.elements])
    args = (center.choi.bloch, outs, tmg4._input_blochs_t(), t0.povm_matrix, t0.n_measurements)
    n_points, iters = MESH_PROCESS
    medians = {}
    for size in (k, 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = sharded_process_bootstrap_distances(meshes[size], 13, *args, n_points=n_points,
                                                cp="ns", cptp_iter=iters).cpu().numpy()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        if d.shape != (n_points,) or not np.all(np.isfinite(d)):
            raise AssertionError("sharded process bootstrap distances are not finite")
        medians[size] = float(np.median(d))
        log(f"    (d) process bootstrap, {tmg4.channel.n_qubits} qubits x "
            f"{len(tmg4.tomographs)} inputs, {n_points} resamples over {size} shard(s), lifp + "
            f"{iters} NS-Dykstra iterations: {seconds:.3f} s = {n_points / seconds:.2f} "
            f"resamples/s, median hs {medians[size]:.4e} on {card}")
    spread = abs(medians[k] - medians[1]) / medians[1]
    if not (PROC_MEDIAN_BAND[0] <= medians[k] <= PROC_MEDIAN_BAND[1] and spread <= 0.10):
        raise AssertionError(f"the sharded process bootstrap medians are off: {medians}")

    n, shots, trials = COVERAGE_QST
    levels = np.linspace(0.05, 0.99, 18)
    problem = verification.qst_problem(qtt.GHZ(n), shots)
    cov = {}
    for size in (k, 1):
        t = time.perf_counter()
        cov[size] = sharded_coverage(meshes[size], 98, problem, levels, trials)
        seconds = time.perf_counter() - t
        log(f"    (d) coverage of GHZ({n}), {shots} shots, {trials} trials over {size} shard(s): "
            f"{seconds:.3f} s = {trials / seconds:.1f} trials/s on {card}")
    gap = float(np.max(np.abs(cov[k] - cov[1])))
    # two independent estimates: 0.05, or five standard errors of their
    # difference where the trials are few
    gap_limit = max(0.05, 5 * math.sqrt(0.5 / trials))
    exact = MESH_COVERAGE_EXACT
    povm, n_meas, blochs, prod, offset, clip_b = problem
    b = torch.as_tensor(blochs, dtype=torch.float32, device=DEVICE)
    hits = sum(verification.coverage_hits(g, povm, n_meas, b, prod, offset, levels, exact // k,
                                          clip_b)
               for g in shard_generators(meshes[k], 7))
    equal = np.array_equal(sharded_coverage(meshes[k], 7, problem, levels, exact), hits / exact)
    log(f"      coverage {np.round(cov[k], 4).tolist()}; {k} vs 1 shard max |diff| {gap:.4f} "
        f"(limit {gap_limit:.3f}); at {exact} trials the hits equal the per-shard "
        f"coverage_hits: {equal}")
    if not (np.all(cov[k] >= levels - 0.05) and gap <= gap_limit and equal):
        raise AssertionError("the sharded coverage is off")


def _mesh_example_row(card, tally):
    """Phase 12, part (e): quantpy_tpu_torch.examples.multichip on the card,
    counted, then rerun under the device audit."""
    import io

    from quantpy_tpu_torch.examples import multichip

    shards = len(multichip._mesh_devices(torch.device(DEVICE))[0])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, seconds, launched = _counted("multichip.main", lambda: multichip.main(
            ["--device", DEVICE]), tally, b1=shards * B1_PER_F32_BATCH)
    for line in buf.getvalue().splitlines():
        log(f"      | {line}")
    audit = DeviceAudit()
    with audit, contextlib.redirect_stdout(None):
        multichip.main(["--device", DEVICE])
        torch.cuda.synchronize()
    log(f"    (e) multichip.main: {seconds:.3f} s, rhor_mle launches {launched} ({shards} "
        f"shards); audited rerun {audit.n_ops} aten ops, off the card: "
        f"{sorted(audit.off_device) or 'none'}")
    if audit.off_device:
        raise AssertionError(f"multichip: operations off {DEVICE}: {sorted(audit.off_device)}")


def phase12_mesh(card, tmg, est, tmg4, rate_ms):
    """The mesh layer on the card; returns the rhor_mle launches of its
    counted runs."""
    log(f"[12] the mesh layer: {MESH_SHARDS} logical shards on one card")
    t0 = time.perf_counter()
    tally = [0]
    _mesh_resample_row(card, tmg, est, rate_ms, tally)
    t1 = time.perf_counter()
    _mesh_operator_checks()
    for n in MESH_KRON:
        try:
            _mesh_operator_row(card, n)
            break
        except torch.cuda.OutOfMemoryError as e:
            if n == MESH_KRON[-1]:
                raise
            log(f"    (b) {n} qubits do not fit on {card}: {str(e).splitlines()[0]}; the row "
                f"runs at {MESH_KRON[-1]} qubits")
            torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _mesh_chain_rows(card, tmg, est)
    t3 = time.perf_counter()
    _mesh_process_and_coverage_rows(card, tmg4)
    t4 = time.perf_counter()
    _mesh_example_row(card, tally)
    t5 = time.perf_counter()
    log(f"    phase 12: {t5 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, "
        f"(d) {t4 - t3:.1f}, (e) {t5 - t4:.1f}); rhor_mle launches in its counted runs "
        f"{tally[0]}, rhor_mle_flat none")
    return tally[0]


# -- phase 13: the port's benchmark and entry points ------------------------


def _bench_row(card, rate_ms):
    """Phase 13, part (a): quantpy_tpu_torch.bench.main in-process at full
    width, its JSON line checked; returns its (rhor_mle, rhor_mle_flat)
    launches."""
    import io

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch import bench
    from quantpy_tpu_torch.ops import kernels

    out, err = io.StringIO(), io.StringIO()
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = bench.main(["--device", DEVICE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    for line in err.getvalue().splitlines():
        log(f"      | {line}")
    last = out.getvalue().splitlines()[-1]
    log(f"    (a) the bench's JSON line: {last}")
    line = json.loads(last)
    extras = line["extras"]
    missing = sorted(set(BENCH_KEYS) - set(extras))
    if line != result or missing or set(line) != {"metric", "value", "unit", "vs_baseline",
                                                  "extras"}:
        raise AssertionError(f"the bench's line is malformed; extras missing {missing}")
    if extras["skipped"]:
        raise AssertionError(f"the bench skipped sections: {extras['skipped']}")

    phase4 = N_POINTS / rate_ms * 1e3
    rel = abs(line["value"] - phase4) / phase4
    log(f"    (a) bench.main: {seconds:.1f} s; value {line['value']} resamples/s against phase "
        f"4's {phase4:.1f} (off by {rel:.3f}, limit {BENCH_RATE_REL}); times "
        f"{extras['times_ms']['value']} ms, spread {extras['spread']['value']} on {card}")
    if not rel <= BENCH_RATE_REL:
        raise AssertionError(f"the bench's value is {rel:.3f} off phase 4's rate")

    design = (bench.N_QUBITS,) + qtt.generate_measurement_matrix("proj-set",
                                                                 bench.N_QUBITS).shape[:2]
    macs = bench.macs_per_resample_iteration(*design)
    flop = bench.flops_per_resample(*design, bench.MLE_ITERS) * bench.N_POINTS
    peak = bench.fp32_peak_tflops(torch.device(DEVICE))
    want = bench.fp32_share_pct(flop, min(extras["times_ms"]["value"]), peak)
    log(f"    (a) {macs} MACs per resample-iteration, {flop / 1e12:.4f} TFLOP per call; FP32 "
        f"peak {peak:.3f} TFLOP/s; mfu_f32_pct {extras['mfu_f32_pct']} against {want:.4f}")
    if design == (4, 81, 16) and macs != 688_128:
        raise AssertionError(f"the bench counts {macs} MACs per resample-iteration")
    if not (abs(extras["mfu_f32_pct"] - want) <= BENCH_MFU_ROUNDING
            and extras["mfu_f32_pct"] <= 100):
        raise AssertionError(f"mfu_f32_pct {extras['mfu_f32_pct']} is not {want}")
    for n, row in extras["state_scaling_kron"].items():
        if int(n) >= 6 and not row["mle_hs"] < TRUTH_HS_LIMIT:
            raise AssertionError(f"the bench's {n}-qubit MLE is {row['mle_hs']} from the truth")
        if int(n) >= bench.SIMULATE_ROW_QUBITS and not {"simulate_s",
                                                        "simulate_chunked_s"} <= set(row):
            raise AssertionError(f"the bench's {n}-qubit row lacks a draw's time: {row}")

    # one launch per f32 'mle-rhor' batch: the headline's build-and-first
    # call and its timed calls, and each kernel variant's timed calls (the
    # flat one after its own build-and-first call); the point estimate runs
    # the plain loop, and the kron 'mle' and process rows launch neither
    want = (B1_PER_F32_BATCH * (1 + bench.HEADLINE_REPS + bench.VARIANT_REPS),
            B1_PER_F32_BATCH * (1 + bench.VARIANT_REPS))
    log(f"    (a) rhor_mle / rhor_mle_flat launches {launched}, the bench's code implies {want}")
    if launched != want:
        raise AssertionError(f"the bench launched {launched}, expected {want}")
    return launched


def _entry_row(card):
    """Phase 13, part (b): entry()'s flagship bootstrap round on the card;
    returns its rhor_mle launches."""
    import numpy as np

    from quantpy_tpu_torch import entry
    from quantpy_tpu_torch.ops import kernels

    fn, args = entry.entry(device=DEVICE)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    if d.device.type != DEVICE:
        raise AssertionError(f"entry()'s distances are on {d.device}")
    median = _check_distances(d.cpu().numpy(), ENTRY_POINTS, "entry()")
    log(f"    (b) entry(): fn(*args) {seconds:.3f} s, {ENTRY_POINTS} distances, median "
        f"{median:.4e}, finite {bool(np.isfinite(d.cpu().numpy()).all())}; rhor_mle / "
        f"rhor_mle_flat launches {launched} on {card}")
    if launched != (B1_PER_F32_BATCH, 0):
        raise AssertionError(f"entry()'s round launched {launched}")
    return launched[0]


def _dryrun_row(card):
    """Phase 13, part (c): dryrun_multichip over MESH_SHARDS logical shards
    of the card under the device audit; returns its rhor_mle launches."""
    import io

    from quantpy_tpu_torch import entry
    from quantpy_tpu_torch.ops import kernels

    buf = io.StringIO()
    audit = DeviceAudit()
    _reset_launches()
    t0 = time.perf_counter()
    with audit, contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(MESH_SHARDS, devices=[torch.device(DEVICE, 0)] * MESH_SHARDS)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    for line in buf.getvalue().splitlines():
        log(f"      | {line}")
    # the state bootstrap's shards and its single-device twin, one f32
    # 'mle-rhor' batch each; no other stage reaches a kernel
    want = (B1_PER_F32_BATCH * (MESH_SHARDS + 1), 0)
    log(f"    (c) dryrun_multichip({MESH_SHARDS}) on {card}: {seconds:.1f} s under the audit "
        f"({audit.n_ops} aten ops, off the card: {sorted(audit.off_device) or 'none'}); "
        f"rhor_mle / rhor_mle_flat launches {launched} (expected {want})")
    if audit.off_device:
        raise AssertionError(f"the dry run ran operations off the card: {sorted(audit.off_device)}")
    if launched != want:
        raise AssertionError(f"the dry run launched {launched}, expected {want}")
    return launched[0]


def phase13_bench_and_entry(card, rate_ms):
    """The port's benchmark and entry points on the card; returns
    the (rhor_mle, rhor_mle_flat) launches of its counted runs."""
    log("[13] the port's benchmark (quantpy_tpu_torch.bench) and entry points "
        "(quantpy_tpu_torch.entry)")
    t0 = time.perf_counter()
    b1, b2 = _bench_row(card, rate_ms)
    t1 = time.perf_counter()
    b1 += _entry_row(card)
    t2 = time.perf_counter()
    b1 += _dryrun_row(card)
    t3 = time.perf_counter()
    log(f"    phase 13: {t3 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}); "
        f"launches in its counted runs: rhor_mle {b1}, rhor_mle_flat {b2}")
    return b1, b2


# -- phase 14: the rest of the surface ------------------------------------------


def _chain_flagship_row(card, tmg, est):
    """Phase 14, part (a): the flagship's counts drawn by the chain sampler
    and by the binary split from one set of probabilities, each estimated
    through B1 (counted); B1 against its plain version on the chain's
    counts. Returns the rhor_mle launches of the counted runs."""
    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.ops.sampling import sample_multinomial
    from quantpy_tpu_torch.tomography import bootstrap_core, state_core

    dev, dtype = tmg.device, tmg.dtype
    n = tmg.state.n_qubits
    d = 2**n
    bloch_est = est.bloch_tensor(dev, dtype)
    povm = torch.as_tensor(tmg.povm_matrix, dtype=dtype, device=dev)
    n_meas = torch.as_tensor(tmg.n_measurements, dtype=dtype, device=dev)
    probs = state_core.experiment_probabilities(povm, bloch_est.expand(N_POINTS, -1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(CHAIN_SEED)
    methods = ("chain", "binary")
    counts = {m: sample_multinomial(gen, n_meas, probs, method=m) for m in methods}
    draw_ms = {m: cuda_ms(lambda m=m: sample_multinomial(gen, n_meas, probs, method=m), 3)
               for m in methods}
    log(f"    (a) {N_POINTS} x {tuple(probs.shape[1:])} counts from phase 3's GHZ-{n} "
        f"estimate, {N_SHOTS} shots per POVM, {dtype}: the chain draw {draw_ms['chain']:.3f} "
        f"ms ({probs.shape[-1] - 1} binomial passes), the binary split "
        f"{draw_ms['binary']:.3f} ms ({(probs.shape[-1] - 1).bit_length()} passes), best of 3, "
        f"ratio {draw_ms['chain'] / draw_ms['binary']:.3f} on {card}")
    for m, c in counts.items():
        if c.device.type != DEVICE or c.shape != probs.shape:
            raise AssertionError(f"the {m} draw is {tuple(c.shape)} on {c.device}")
        if not bool((c.sum(-1) == n_meas).all()):
            raise AssertionError(f"the {m} draw's row totals are not exact")

    hs, inits, launches = {}, {}, 0
    for m, c in counts.items():
        init = inits[m] = state_core.estimate_lin(c, povm, n_meas)
        audit = DeviceAudit()
        _reset_launches()
        with audit:
            blochs = state_core.estimate_mle_rhor(c, povm, n_meas, init, max_iter=MLE_ITERS)
            torch.cuda.synchronize()
        launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
        if launched != (B1_PER_F32_BATCH, 0):
            raise AssertionError(f"estimate_mle_rhor on the {m} counts launched {launched}")
        if audit.off_device:
            raise AssertionError(f"(a) {m}: operations off the card: {sorted(audit.off_device)}")
        launches += launched[0]
        hs[m] = bootstrap_core._distance_batch("hs", blochs, bloch_est, n).double()
    # B1's inputs on the chain's counts as estimate_mle_rhor builds them,
    # through the plain loop
    freq = state_core._frequencies(counts["chain"])
    bloch0 = state_core._mixed_start(inits["chain"], d, 0.05)
    a2 = state_core.weighted_povm_flat(povm, n_meas) * d
    plain = kernels.rhor_mle_reference(freq, bloch0, a2, MLE_ITERS)
    hs_plain = bootstrap_core._distance_batch("hs", plain, bloch_est, n).double()
    err32 = float((hs["chain"] - hs_plain).abs().max())
    medians = {}
    for m in methods:
        sample = hs[m].cpu().numpy()
        medians[m] = _check_distances(sample, N_POINTS, f"(a) the {m} draw's MLE-{MLE_ITERS}")
    rel = abs(medians["chain"] - medians["binary"]) / medians["binary"]
    log(f"      estimate_lin + estimate_mle_rhor (RrhoR-{MLE_ITERS}) + hs on each: rhor_mle "
        f"launches {launches} (expected {2 * B1_PER_F32_BATCH}); median hs chain "
        f"{medians['chain']:.4e}, binary {medians['binary']:.4e} (off by {rel:.4f}, limit "
        f"{CHAIN_MEDIAN_REL}; band {MEDIAN_BAND}); B1 against the plain loop on the chain's "
        f"counts, max|delta hs| {err32:.3e} (limit {HS_TOL_F32:.0e})")
    if not err32 <= HS_TOL_F32:
        raise AssertionError(f"B1 disagrees with the plain loop on the chain's counts: {err32}")
    if not rel <= CHAIN_MEDIAN_REL:
        raise AssertionError(f"the chain draw's median hs is {rel:.4f} off the binary split's")
    return launches


def _kron_sums(counts, n_shots):
    """Per-outcome sums over the POVM rows, and whether every row holds
    exactly `n_shots`."""
    exact = bool((counts.sum(-1) == n_shots).all())
    return counts.double().sum(-2), exact


def _chunked_kron_row(card):
    """Phase 14, part (b): GHZ-n with proj-set, N_SHOTS shots per POVM,
    drawn fused (`kron_simulate`) and in blocks (`kron_simulate_chunked`):
    times, peaks, exact row totals, per-outcome sums within 5 standard
    errors; then the one-block draw equal to the fused one bit for bit."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.ops.paulis import group_sizes
    from quantpy_tpu_torch.tomography import kron_core

    n, n_equal = SURFACE_KRON
    dev, f32 = torch.device(DEVICE), torch.float32
    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=f32, device=dev)
    truth = qtt.GHZ(n).bloch_tensor(dev, f32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(140 + n)
    rows = {}
    for name, draw in (("kron_simulate", kron_core.kron_simulate),
                       ("kron_simulate_chunked", kron_core.kron_simulate_chunked)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counts = draw(gen, povm1, truth, N_SHOTS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        if counts.device.type != DEVICE or counts.shape != (3**n, 2**n):
            raise AssertionError(f"{name} returned {tuple(counts.shape)} on {counts.device}")
        sums, exact = _kron_sums(counts, N_SHOTS)
        rows[name] = (seconds, peak, sums, exact)
        del counts
    probs = kron_core.kron_probs(povm1.double(), n, truth.double())
    probs = probs / probs.sum(-1, keepdim=True)
    var = (N_SHOTS * probs * (1 - probs)).sum(-2)
    expected = (N_SHOTS * probs).sum(-2)
    del probs
    (s_f, p_f, sum_f, ok_f), (s_c, p_c, sum_c, ok_c) = rows.values()
    z_pair = float(((sum_f - sum_c).abs() / (2 * var).sqrt().clamp(min=1e-300)).max())
    z_truth = max(float(((s - expected).abs() / var.sqrt().clamp(min=1e-300)).max())
                  for s in (sum_f, sum_c))
    m0 = 3 ** group_sizes(n)[0]
    log(f"    (b) GHZ-{n}, proj-set, {N_SHOTS} shots per POVM, float32 on {card}: "
        f"{3**n} x {2**n} counts ({3**n * 2**n * 4 / 1e9:.2f} GB)")
    log(f"      kron_simulate {s_f:.3f} s, peak {p_f:.2f} GiB; kron_simulate_chunked ({m0} "
        f"blocks) {s_c:.3f} s, peak {p_c:.2f} GiB; row totals exact: {ok_f}, {ok_c}; "
        f"per-outcome sums, largest |fused - chunked| {z_pair:.2f} SE, largest |draw - n p| "
        f"{z_truth:.2f} SE (limit 5)")
    if not (ok_f and ok_c):
        raise AssertionError("a GHZ-12 draw's row totals are not exact")
    if not (z_pair <= 5 and z_truth <= 5):
        raise AssertionError(f"the fused and chunked draws disagree: {z_pair}, {z_truth} SE")

    truth = qtt.GHZ(n_equal).bloch_tensor(dev, f32)
    draws = []
    for draw in (kron_core.kron_simulate,
                 lambda *a: kron_core.kron_simulate_chunked(*a, n_calls=1)):
        gen.manual_seed(141)
        draws.append(draw(gen, povm1, truth, N_SHOTS))
    same = torch.equal(*draws)
    log(f"      GHZ-{n_equal}: kron_simulate_chunked(n_calls=1) equals kron_simulate on a "
        f"reseeded generator bit for bit: {same}")
    if not same:
        raise AssertionError("the one-block chunked draw differs from kron_simulate")


def _state_chunk_row(card):
    """Phase 14, part (c): phase 9's channel design, channel_l2_moments_kron
    at two state chunkings on the same probes, float64."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.tomography import kron_analytic

    n, shots, chunks, n_probes = SURFACE_CHANNEL
    dev = torch.device(DEVICE)
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=97)  # phase 9's
    tmg.experiment(shots)
    freq3 = np.stack([t.results / t.n_measurements[:, None] for t in tmg.tomographs])
    n_trials = tmg.tomographs[0].n_measurements[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(142)
    probes = torch.randint(0, 2, (n_probes,) + (4,) * n, generator=gen, device=dev)
    probes = probes.to(torch.float64) * 2 - 1
    out = {}
    for chunk in chunks:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        moments = kron_analytic.channel_l2_moments_kron(
            tmg._states1_t, tmg._povm1, n, freq3, n_trials, state_chunk=chunk, probes=probes,
            device=dev)
        torch.cuda.synchronize()
        out[chunk] = (moments, time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated() / 2**20)
    (m_a, s_a, p_a), (m_b, s_b, p_b) = out.values()
    rel = max(abs(a - b) / abs(b) for a, b in zip(m_a, m_b))
    log(f"    (c) channel_l2_moments_kron on depolarizing(0.1, {n}), {len(freq3)} inputs, "
        f"{shots} shots, {n_probes} probes, float64 on {card}: state_chunk {chunks[0]} "
        f"{s_a:.3f} s, peak {p_a:.1f} MiB; state_chunk {chunks[1]} {s_b:.3f} s, peak "
        f"{p_b:.1f} MiB; (mean, variance) ({m_b[0]:.9e}, {m_b[1]:.9e}), largest relative "
        f"difference {rel:.3e} "
        f"(limit {SURFACE_CHANNEL_REL:.0e})")
    if not (all(math.isfinite(v) for v in m_a + m_b) and rel <= SURFACE_CHANNEL_REL):
        raise AssertionError(f"the state chunkings disagree: {m_a} against {m_b}")


def _pgdb_host_row(card):
    """Phase 14, part (d): estimate_pgdb_factored_host from a lifp warm
    start, float64: against estimate_pgdb_factored, and the card against
    the CPU."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.tomography import process_core

    n, shots, n_iter, cptp_iter = SURFACE_PGDB
    f64 = torch.float64
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=143, dtype=f64)
    tmg.experiment(shots)
    design = tmg._design()  # counts, input blochs, POVM, shots per POVM
    kwargs = dict(max_iter=n_iter, cptp_iter=cptp_iter)

    def run(device, fn):
        args = tuple(x.to(device) for x in design)
        init = process_core.estimate_lifp_factored(*args, cptp_iter=cptp_iter)
        return fn(*args, init_bloch=init, **kwargs)

    t0 = time.perf_counter()
    host = run(DEVICE, process_core.estimate_pgdb_factored_host)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fused = run(DEVICE, process_core.estimate_pgdb_factored)
    on_cpu = run("cpu", process_core.estimate_pgdb_factored_host)
    gap = float((host - fused).abs().max())
    card_cpu = float((host.cpu() - on_cpu).abs().max())
    log(f"    (d) estimate_pgdb_factored_host, depolarizing(0.1, {n}), {shots} shots, lifp "
        f"warm start, {n_iter} iterations, {cptp_iter} Dykstra iterations, float64: "
        f"{seconds:.2f} s on {card}; max|delta| against estimate_pgdb_factored {gap:.3e}, "
        f"card against the CPU {card_cpu:.3e} (limit {SURFACE_PGDB_TOL:.0e})")
    if host.device.type != DEVICE or host.dtype != f64:
        raise AssertionError(f"the host pgdb returned {host.dtype} on {host.device}")
    if not (gap <= SURFACE_PGDB_TOL and card_cpu <= SURFACE_PGDB_TOL):
        raise AssertionError(f"the host pgdb disagrees: {gap}, {card_cpu}")


def _df32_and_cplx_row(card):
    """Phase 14, part (e): ops/df32 and ops/cplx on the card against
    float64 and against themselves."""
    import numpy as np

    from quantpy_tpu_torch.ops import cplx, df32

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(144)
    n = SURFACE_DF32_N
    a = torch.randn(n, generator=gen, device=dev) * 1e3
    b = torch.randn(n, generator=gen, device=dev)
    s, e = df32.two_sum(a, b)
    sum_exact = bool(torch.equal(s.double() + e.double(), a.double() + b.double()))
    p, e = df32.two_prod(a, b)
    prod_exact = bool(torch.equal(p.double() + e.double(), a.double() * b.double()))
    den = b.abs() + 1e-3
    hi, lo = df32.df_div_ff(a, den)
    div_rel = float(((hi.double() + lo.double()) - a.double() / den.double()).abs()
                    .div(a.double().abs() / den.double()).max())
    x = torch.rand(n, generator=gen, device=dev)
    total = df32.sum2f(x)
    want = x.double().sum()
    ulps = float((total.double() - want).abs() / torch.finfo(torch.float32).eps
                 / want.float().abs().double())
    plain = float((x.sum().double() - want).abs() / want)
    z = (torch.randn(64, 16, generator=gen, device=dev)
         + 1j * torch.randn(64, 16, generator=gen, device=dev)).to(torch.complex64)
    host_z = z.cpu().numpy()
    pair = cplx.to_pair(host_z)
    back = cplx.from_pair(pair)
    as_complex = cplx.pair_to_complex(pair)
    round_trip = (pair.device.type == DEVICE and np.array_equal(back, host_z)
                  and torch.equal(as_complex, z) and torch.equal(cplx.complex_to_pair(z), pair))
    log(f"    (e) on {card}, {n} float32 numbers: two_sum exact {sum_exact}, two_prod exact "
        f"{prod_exact}; df_div_ff (hi, lo) against float64 {div_rel:.3e} relative (limit "
        f"2^-40 = {SURFACE_DF32_REL:.3e}); sum2f {ulps:.3f} float32 ulp from the float64 sum "
        f"(limit 1; torch.sum's float32 result {plain:.3e} relative); to_pair / from_pair / "
        f"pair_to_complex / complex_to_pair round trip exact: {round_trip}")
    if not (sum_exact and prod_exact and round_trip):
        raise AssertionError("an error-free transformation or a pair conversion is not exact")
    if not (div_rel <= SURFACE_DF32_REL and ulps <= 1.0):
        raise AssertionError(f"df32 off float64: div {div_rel}, sum2f {ulps} ulp")


def phase14_surface(card, tmg, est):
    """The rest of the surface on the card; returns the rhor_mle launches
    of its counted runs."""
    log("[14] the rest of the surface: the chain sampler, the chunked kron draw, "
        "state_chunk, the host pgdb, ops/df32 and ops/cplx")
    t0 = time.perf_counter()
    launches = _chain_flagship_row(card, tmg, est)
    t1 = time.perf_counter()
    _chunked_kron_row(card)
    t2 = time.perf_counter()
    _state_chunk_row(card)
    t3 = time.perf_counter()
    _pgdb_host_row(card)
    t4 = time.perf_counter()
    _df32_and_cplx_row(card)
    t5 = time.perf_counter()
    log(f"    phase 14: {t5 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, "
        f"(d) {t4 - t3:.1f}, (e) {t5 - t4:.1f}); rhor_mle launches in its counted runs "
        f"{launches}, rhor_mle_flat none")
    return launches


def main() -> int:
    card = phase0_device()
    log(card)
    sys.path.insert(0, str(REPO))
    phase1_build()
    measured = phase2_kernel_vs_plain()
    tmg, est, launches = phase3_main_path(card)
    rate_ms = phase4_rate(card, tmg, est)
    flat_launches = phase5_flat_path(card, tmg, est)
    phase6_cholesky_mle(card)
    phase7_kron(card)
    process_launches, process_tmg = phase8_process(card)
    launches += process_launches
    phase9_intervals(card)
    phase10_mcmc(card, tmg, est, process_tmg)
    launches += phase11_entry_points(card, tmg, process_tmg, rate_ms)
    launches += phase12_mesh(card, tmg, est, process_tmg, rate_ms)
    bench_b1, bench_b2 = phase13_bench_and_entry(card, rate_ms)
    launches += bench_b1
    flat_launches += bench_b2
    launches += phase14_surface(card, tmg, est)
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
