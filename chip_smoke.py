#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check or exception ends the run with a
non-zero exit code, and nothing falls back to the CPU. The script checks;
the cells of BENCHMARK.json time (`python3 -m benchmark.run`). The one
timed phase is 2, whose kernel-against-plain times fill PERF.md's kernel
table; the other phases print values, errors, launch counts and peak
memory, never a time or a rate. There is no phase 4: the cells time the
bootstrap.

0. Device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi) and the torch and CUDA versions.
1. Build the four kernels from quantpy_tpu_torch/csrc/ with nvcc
   (sm_90a), one nvcc per source, started together; print ptxas's
   register and spill lines.
2. Each kernel (rhor_mle, the lane kernel; rhor_mle_flat, the flat-matrix
   kernel) against its plain PyTorch version on identical CUDA inputs
   (n = 1, 2, 3, 4, 5, 6 in float32, n = 2, 4 in float64, ragged batches,
   40 iterations), the two plain versions against each other in float64,
   then each kernel and its plain version timed in turns at the flagship
   shape (B = 16384, K = 1296, D = 256, 60 iterations) with CUDA events,
   beside the least time the card could take (`bound_ms`). Then the PSD
   projection kernel (psd_project: batched Jacobi, eigenvalue floor and
   recomposition), called through its wrapper, against its plain version
   and torch.linalg.eigh's projection on random Hermitian complex64
   batches (d = 4, 16, 64; batches 1, 64, 4,096) and on a Dykstra step's
   input (64 Choi matrices of 64 x 64, near depolarizing(0.1, 3)), then
   timed on that input with CUDA events, best of 4, beside its bound (the
   least work of the function: Householder tridiagonalisation, the
   eigenvectors' back-transformation and the Hermitian recomposition), its
   plain version and the eigh projection (`library_ms`). Then the
   eigenvalue clip kernel (psd_clip: cluster Jacobi, floor at 1e-15, unit
   trace, first-order refinement) against its plain version and the
   torch.linalg.eigh clip of make_feasible_bloch, and against a float64
   clip beside the float32 eigh clip's error, on W-state-like 8-qubit
   linear estimates (19 and 256 complex64 matrices of 256 x 256: a kron
   bootstrap chunk and a whole interval's resamples), each timed with CUDA
   events, best of 4 in turns (the plain version at 256 matrices of 2),
   beside its bound (17.3 d^3 flops a matrix, as for psd_project).
3. Main path: StateTomograph(GHZ(4)) built without device=, so on the
   default device, which must be "cuda"; a 10^4-shot proj-set experiment,
   the RrhoR point estimate (a single experiment: the plain loop, which
   stops at its tolerance) and a 16,384-resample bootstrap interval
   (RrhoR-60: one launch of the lane kernel), with the kernels' launch
   counts and the device of every tensor operation checked; then kernel
   and plain versions held against each other on one fixed draw of counts.
5. The flat kernel on the main path: the flagship bootstrap_distances call
   with kernels.rhor_mle replaced by kernels.rhor_mle_flat (as bench.py
   swaps the JAX kernels), launch counts and devices checked; flat and
   lane kernels held against each other on one fixed draw of counts.
6. Cholesky MLE ('mle', batched L-BFGS) on the card: GHZ-4 point estimates
   ('mle-constr' must equal 'mle'), a 1,024-resample bootstrap interval
   audited for devices and for kernel launches (none), the per-resample
   likelihood of 'mle' beside RrhoR-60 on one fixed draw, and the float64
   agreement of 'mle' and 'mle-rhor' at 2 qubits.
7. The kron-factored path on the card: its chains, lin and RrhoR against
   the dense path at 4 qubits; StateTomograph(GHZ(6)) in kron mode; the
   6-qubit 256-resample MLE bootstrap of bench.py, audited; bench.py's
   scaling rows (6, 8, 10, 11 qubits: simulate, lin and MLE-60, hs to the
   truth, peak memory); bench.py's 10-qubit 16-resample bootstrap;
   w8-rhor256's 8-qubit W-state bootstrap cut to 40 resamples ('mle-rhor'
   from lin starts, three chunks), its psd_clip launches counted from 0
   and held to one per chunk (the kernels line's psd_clip launches).
8. Process tomography on the card (no kernel of its own): at 2 qubits in
   float64 all four estimators of ProcessTomograph(depolarizing(0.1, 2))
   and the Newton-Schulz CP engine against eigh; lifp, the projection with
   both engines and states_to_choi_bloch on the card against the CPU on one
   set of counts; the launch counts of method='states' (one rhor_mle launch
   with 'mle-rhor' in float32, none with 'lin'); then the 4-qubit process
   bootstrap of bench.py (depolarizing(0.1, 4), 256 proj4 inputs, proj-set,
   2,000 shots per POVM, lifp + CPTP, 256 resamples, float32): audited for
   devices, float64 operations and kernel launches (none), two seeds'
   quantiles held together, each resampled Choi matrix checked for TP and
   CP, peak memory; and a 3-qubit 64-resample bootstrap on the 'eigh'
   engine: peak memory and its psd_project launches, counted from 0 and
   held to one per Dykstra step (the kernels line's psd_project launches).
9. The analytic confidence intervals on the card (no kernel of their own):
   (a) every interval of the slice (moment, Sugiyama, moment-fidelity,
   polytope on all three LP paths, Holder), count_delta and the coverage
   hits on 2-qubit tomographs in float64, the card against the CPU on the
   same counts (equal lp_iterations); (b) full-width rows in float32,
   each audited for devices, float64 operations and kernel launches (none),
   with radii or bounds, lp_iterations and peak memory; each polytope's
   two LP solves with their last residual readings, the margins that
   report the 1.0 marker of a failed solve, and its other margins held to
   bracket the true point wherever it is feasible: GHZ-4 dense
   (1,000-margin polytope), the f32 polytope against a float64 rerun,
   GHZ-6 in kron mode (200 margins), depolarizing(0.1, 4) with 256 inputs
   (exact per-state moments, Holder's 256 children, the two-factor
   polytope at 25 margins) and its Hutchinson moments; (c) the coverage
   harness at 10^4 trials x 18 levels (GHZ-4; 3-qubit QPT with sic
   inputs).
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
   acceptance, R-hat, ESS, radii and peak memory.
11. The user entry points on the card (rhor_mle through the f32 bootstrap
   batches, never rhor_mle_flat): (a) the state CLI
   (`quantpy_tpu_torch.cli.state_interval.main`) on phase 3's GHZ-4
   experiment written as a JSON record, --method mle-rhor with the
   16,384-resample bootstrap (one rhor_mle launch), the moment, Sugiyama
   and 500-margin polytope intervals, and `python -m
   quantpy_tpu_torch.cli.state_interval --no-ci` in a process of its own;
   (b) a GHZ-6 kron-mode record (moment, 256-resample bootstrap); (c) the
   process CLI on phase 8's 4-qubit experiment (lifp; moment, 256-resample
   bootstrap); each invocation a counted run in a StageTimer stage, its
   output checked, and an audited rerun; (d) every deterministic output of
   both CLIs on examples/data's records, the card against the CPU in
   float64 (1e-10 of scale, equal lp_iterations) and float32 against
   float64 (5e-3); (e) resumable_bootstrap (16,384 resamples in chunks of
   4,096, one launch each) interrupted after 2 chunks and resumed, equal to
   the uninterrupted run, the StageTimer's stages of (a)-(c) and a
   utils.trace() of one bootstrap call that names the kernel; (f) the
   examples at reduced sizes, figures off, each counted, then rerun under
   the device audit (its MCMC chains and 'pgdb' loops shortened). Every
   counted run resets the kernels' counts before it and reads them after.
12. The mesh layer (`quantpy_tpu_torch.parallel`) on MESH_SHARDS logical
   shards of the one card, float32 unless stated: (a) phase 3's GHZ-4
   bootstrap, 16,384 resamples with RrhoR-60, over 4 shards (one rhor_mle
   launch per shard, counted) and over 1, equal to the shards'
   single-device calls on the shards' generators; (b) the 6-qubit
   operator-sharded functions against kron_core in float64, then GHZ-12
   with proj-set (8.7 GB of counts): the operator-sharded simulate, lin
   and MLE-60 with peak memory and hs to the truth, then the
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
   `skipped` empty, `mfu_f32_pct` equal to 1.353 TFLOP over the best call
   and the card's FP32 peak, the 6-11 qubit MLE rows within
   TRUTH_HS_LIMIT of the truth, and the rhor_mle and rhor_mle_flat
   launches equal to those its code implies; (b)
   `quantpy_tpu_torch.entry.entry()`'s flagship round (256 resamples,
   RrhoR-100: one rhor_mle launch); (c) `entry.dryrun_multichip` over
   MESH_SHARDS logical shards of the card under the device audit, with its
   rhor_mle launches. Each counted run resets the kernels' counts before
   it and reads them after.
14. The rest of the surface, float32 unless stated: (a) phase 3's 16,384 x
   81 x 16 flagship counts drawn by the chain sampler
   (`sample_multinomial(..., method="chain")`) and by the binary split from
   one set of probabilities, each with exact row totals, each estimated by
   estimate_lin and RrhoR-60 (one rhor_mle launch each, counted, under the
   device audit) and held to phase 3's median band, the two medians within
   CHAIN_MEDIAN_REL, and B1 held to its plain version on the chain's
   counts (HS_TOL_F32); (b) GHZ-12, proj-set, 10^4 shots: `kron_simulate`
   and `kron_simulate_chunked` (27 blocks), each with its peak memory,
   exact row totals and per-outcome sums within 5 standard errors of each
   other and of n p, then at 8 qubits the one-block chunked draw equal to
   `kron_simulate` bit for bit on a reseeded generator; (c) phase 9's
   4-qubit channel design through `channel_l2_moments_kron` at state_chunk
   64 and 256 on the same 128 probes, float64, equal to 1e-10 relative,
   with each one's peak; (d) `estimate_pgdb_factored_host` at 2 qubits in
   float64 (15 steps from a lifp warm start) against
   `estimate_pgdb_factored` and against the CPU (1e-10); (e) `ops/df32`
   and `ops/cplx` on 10^6 float32 numbers: two_sum and two_prod exact
   against float64, df_div_ff within 2^-40, sum2f within one float32 ulp of
   the float64 sum, the pair conversions exact. Phases 3, 5, 8, 11, 12, 13
   and 14's counted launches make the kernels line's counts
   (psd_project's: phase 8's 'eigh' bootstrap alone; psd_clip's: phase 7's
   8-qubit W-state bootstrap alone).

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
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
PSD_KERNEL = "psd_project"
PSD_BATCH, PSD_DIM = 64, 64  # a Dykstra step of the 3-qubit 64-resample interval
CLIP_KERNEL = "psd_clip"
# (matrices, d): a chunk of w8-rhor256's kron bootstrap, and its 256 resamples
CLIP_SHAPES = ((19, 256), (256, 256))
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
# w8-rhor256's kron bootstrap, cut to fewer resamples: qubits and resamples
# (three of its chunks of 19); each chunk's lin starts clip in
# CLIP_LAUNCHES_PER_CHUNK psd_clip launches
KRON_CLIP_ROW = (8, 40)
CLIP_LAUNCHES_PER_CHUNK = 1
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
PSD_LAUNCHES_PER_STEP = 1  # psd_project launches per Dykstra step of the 'eigh' row
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
# chunk: every PDHG iteration runs the same operations.
AUDIT_LP_ITERS = 500
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
# MCMC_MIN_EIG.
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


def phase0_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    if not all((REPO / "quantpy_tpu_torch" / "csrc" / f"{k}.cu").is_file()
               for k in KERNELS + (PSD_KERNEL, CLIP_KERNEL)):
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

    names = KERNELS + (PSD_KERNEL, CLIP_KERNEL)
    log(f"[1] building {', '.join(k + '.cu' for k in names)} with {_build.nvcc_path()}")
    nvcc_version = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    log(f"    {nvcc_version}")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    for name in KERNELS:
        kernels._library(name)
    kernels._psd_library()
    kernels._clip_library()
    for name in names:
        _, output = _build.build_log.get(name, (0.0, ""))
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


def _psd_eigh_projection(a):
    """The eigh projection that process_core runs where the kernel does
    not: torch.linalg.eigh, eigenvalues floored at 1e-12, recomposed."""
    evals, evecs = torch.linalg.eigh(a)
    evals = evals.clamp(min=1e-12)
    return (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)


def _psd_step_batch(seed):
    """A Dykstra step's CP input: PSD_BATCH Choi matrices of
    depolarizing(0.1, 3), each moved off the PSD cone by Hermitian noise,
    complex64 on the card."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops.paulis import bloch_to_matrix

    choi = torch.as_tensor(qtt.depolarizing(0.1, 3).choi.bloch, dtype=torch.float64)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(PSD_BATCH, PSD_DIM, PSD_DIM, dtype=torch.complex128, generator=gen)
    a = bloch_to_matrix(choi[None], 6) + 0.02 * (x + x.conj().transpose(-1, -2))
    return a.to(DEVICE, torch.complex64).contiguous()


def phase2_psd_kernel():
    """The PSD projection kernel against its plain version and the eigh
    projection, then timed at a Dykstra step's shape; returns its row of
    the kernels line."""
    from quantpy_tpu_torch.ops import kernels

    log("[2] psd_project against its plain version and torch.linalg.eigh's projection")
    cases = []
    for d in (4, 16, 64):
        for batch in (1, 64, 4096):
            gen = torch.Generator().manual_seed(d * batch)
            x = torch.randn(batch, d, d, dtype=torch.complex64, generator=gen).to(DEVICE)
            cases.append((f"random d={d:2d} B={batch:4d}", x + x.conj().transpose(-1, -2)))
    step = _psd_step_batch(seed=64)
    cases.append((f"Dykstra step d={PSD_DIM} B={PSD_BATCH}", step))
    worst = 0.0
    for name, a in cases:
        out = kernels.psd_project(a)
        sweeps = torch.zeros(a.shape[0], dtype=torch.int32, device=DEVICE)
        kernels._psd_launch(a, sweeps)
        torch.cuda.synchronize()
        scale = a.abs().amax((-2, -1), keepdim=True)
        errs = [float(((out - ref).abs() / scale).max())
                for ref in (kernels.psd_project_reference(a), _psd_eigh_projection(a))]
        log(f"    {name}: sweeps {int(sweeps.min())}-{int(sweeps.max())} "
            f"(cap {kernels.PSD_MAX_SWEEPS}), max|kernel-plain| {errs[0]:.3e}, "
            f"max|kernel-eigh| {errs[1]:.3e} (relative to max|A|, limit {TOL['float32']:.0e})")
        if not (max(errs) <= TOL["float32"] and int(sweeps.max()) < kernels.PSD_MAX_SWEEPS):
            raise AssertionError(f"psd_project on {name}: {errs}, sweeps {int(sweeps.max())}")
        worst = max(worst, *errs)

    run_kernel = lambda: kernels.psd_project(step)  # noqa: E731
    run_plain = lambda: kernels.psd_project_reference(step)  # noqa: E731
    run_library = lambda: _psd_eigh_projection(step)  # noqa: E731
    run_library()
    kernel_ms, plain_ms = _in_turns(run_kernel, run_plain, 4)
    library_ms = cuda_ms(run_library, 4)
    # the least work of the function, whatever algorithm computes it:
    # Householder reduction of each Hermitian matrix to tridiagonal form
    # (16/3 d^3 flops), the reflectors applied to the tridiagonal's
    # eigenvectors (8 d^3) and the Hermitian product V diag(l) V^H (4 d^3);
    # the tridiagonal eigensolve, whose work depends on deflation, is left
    # out. 2 d^2 complex64 in and out.
    d = PSD_DIM
    flops = PSD_BATCH * (16 / 3 + 8 + 4) * d**3
    ops_ms = flops / PEAK_FLOPS["float32"] * 1e3
    bytes_ms = 2 * step.numel() * step.element_size() / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"    Dykstra step shape B={PSD_BATCH} d={d} complex64: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, eigh projection (library) {library_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({flops / 1e9:.3f} GFLOP at 67 TFLOP/s), kernel at "
        f"{bound_ms / kernel_ms:.3f} of the bound")
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_share": bound_ms / kernel_ms, "library_ms": library_ms}


def _eigh_clip(a):
    """make_feasible_bloch's eigh clip: torch.linalg.eigh, eigenvalues
    floored at 1e-15 and divided by their sum, recomposed."""
    evals, evecs = torch.linalg.eigh(a)
    evals = evals.clamp(min=1e-15)
    evals = evals / evals.sum(-1, keepdim=True)
    return (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)


def _w_like_states(batch, d, seed):
    """(batch, d, d) complex128 on the card: the W state's density matrix
    plus Hermitian noise whose spectrum spans about +-0.1, as the 8-qubit
    linear estimates of w8-rhor256 do (half their eigenvalues negative)."""
    n = int(round(math.log2(d)))
    w = torch.zeros(d, dtype=torch.complex128)
    w[[1 << k for k in range(n)]] = 1 / math.sqrt(n)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, d, d, dtype=torch.complex128, generator=gen)
    noise = 0.1 / (2 * math.sqrt(2 * d)) * (x + x.conj().transpose(-1, -2))
    return (torch.outer(w, w.conj()) + noise).to(DEVICE)


def phase2_clip_kernel():
    """The eigenvalue clip kernel against its plain version, the eigh clip
    and float64, then timed; returns its row of the kernels line."""
    from quantpy_tpu_torch.ops import kernels

    log("[2] psd_clip against its plain version, the eigh clip and float64")
    worst, timed = 0.0, {}
    for batch, d in CLIP_SHAPES:
        a64 = _w_like_states(batch, d, seed=batch)
        a = a64.to(torch.complex64).contiguous()
        out = kernels.psd_clip(a)
        sweeps = torch.zeros(batch, dtype=torch.int32, device=DEVICE)
        kernels._clip_launch(a, sweeps)
        torch.cuda.synchronize()
        scale = a.abs().amax((-2, -1), keepdim=True)
        errs = [float(((out - ref).abs() / scale).max())
                for ref in (kernels.psd_clip_reference(a), _eigh_clip(a))]
        exact = _eigh_clip(a64)
        err64 = float((out.to(torch.complex128) - exact).abs().max())
        eigh64 = float((_eigh_clip(a).to(torch.complex128) - exact).abs().max())
        log(f"    B={batch} d={d}: sweeps {int(sweeps.min())}-{int(sweeps.max())} "
            f"(cap {kernels.PSD_MAX_SWEEPS}), max|kernel-plain| {errs[0]:.3e}, max|kernel-eigh| "
            f"{errs[1]:.3e} (relative to max|A|, limit {TOL['float32']:.0e}); against float64: "
            f"kernel {err64:.3e}, eigh {eigh64:.3e} (limit twice the eigh's)")
        if not (max(errs) <= TOL["float32"] and int(sweeps.max()) < kernels.PSD_MAX_SWEEPS
                and err64 <= 2 * eigh64):
            raise AssertionError(f"psd_clip at B={batch} d={d}: {errs}, {err64} against {eigh64}")
        worst = max(worst, *errs)

        run_kernel = lambda: kernels.psd_clip(a)  # noqa: E731
        run_plain = lambda: kernels.psd_clip_reference(a)  # noqa: E731
        run_library = lambda: _eigh_clip(a)  # noqa: E731
        run_library()
        kernel_ms, plain_ms = _in_turns(run_kernel, run_plain, 4 if batch < 64 else 1)
        kernel_ms = min(kernel_ms, cuda_ms(run_kernel, 4))
        library_ms = cuda_ms(run_library, 4)
        # the least work of the clip, as for psd_project: 17.3 d^3 flops a
        # matrix; 2 d^2 complex64 in and out
        flops = batch * (16 / 3 + 8 + 4) * d**3
        ops_ms = flops / PEAK_FLOPS["float32"] * 1e3
        bytes_ms = 2 * a.numel() * a.element_size() / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"    B={batch} d={d} complex64: kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms, "
            f"eigh clip (library) {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({flops / 1e9:.2f} GFLOP at 67 TFLOP/s), kernel at {bound_ms / kernel_ms:.4f} of the bound")
        timed[batch] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                        "bound_share": bound_ms / kernel_ms, "library_ms": library_ms}
    return {"max_abs_err": worst, **timed[CLIP_SHAPES[0][0]]}


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
        f"median {median:.4e}")
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


def phase5_flat_path(tmg, est):
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


def phase6_cholesky_mle():
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
    interval = qtt.BootstrapStateInterval(
        tmg, n_points=n_points, method="mle", max_iter=max_iter, key=6, state=est
    )
    dists, _ = interval((0.5, 0.9, 0.99))
    median = _check_distances(interval.distances, n_points, "'mle' bootstrap")
    log(f"    BootstrapStateInterval('mle', {n_points} resamples, max_iter {max_iter}): hs at "
        f"(0.5, 0.9, 0.99) {[float(x) for x in dists]}; median {median:.4e} (the audited "
        f"pass: max_iter {max_iter // 10})")
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
    MLE-60 of it, hs to the truth, peak memory."""
    from quantpy_tpu_torch.tomography import bootstrap_core, kron_core

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    counts = kron_core.kron_simulate(gen, povm1, truth, N_SHOTS)
    lin = kron_core.kron_estimate_lin(counts, povm1, n)
    mle = kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=MLE_ITERS)
    out["lin_hs"] = float(bootstrap_core._distance_batch("hs", lin, truth, n))
    out["mle_hs"] = float(bootstrap_core._distance_batch("hs", mle, truth, n))
    torch.cuda.synchronize()
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["counts_shape"] = list(counts.shape)
    return out


def phase7_kron(card):
    """Returns the psd_clip launches of the W-state bootstrap row."""
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
    rows = {}
    for n in KRON_SCALING:
        truth = qtt.GHZ(n).bloch_tensor(dev, dtype)
        gen.manual_seed(100 + n)
        rows[n] = row = _scaling_row(n, povm1, truth, gen)
        log(f"    scaling n={n} counts {tuple(row['counts_shape'])}, MLE-{MLE_ITERS}: hs to the "
            f"truth lin {row['lin_hs']:.4e}, MLE {row['mle_hs']:.4e}; peak memory "
            f"{row['peak_mib']:.1f} MiB on {card}")
        if not 0 <= row["mle_hs"] < TRUTH_HS_LIMIT:
            raise AssertionError(
                f"{n}-qubit MLE hs to the truth {row['mle_hs']} (limit {TRUTH_HS_LIMIT})")

    # bench.py's large bootstrap, centred on the lin estimate as there
    n, n_points = KRON_BOOT
    gen.manual_seed(110)
    counts = kron_core.kron_simulate(gen, povm1, qtt.GHZ(n).bloch_tensor(dev, dtype), N_SHOTS)
    center = kron_core.kron_estimate_lin(counts, povm1, n)
    del counts
    dists = kron_core.kron_bootstrap_distances(
        gen, center, povm1, n, N_SHOTS, n_points=n_points, method="mle", max_iter=MLE_ITERS)
    if not bool(torch.isfinite(dists).all()):
        raise AssertionError(f"{n}-qubit bootstrap distances are not finite")
    log(f"    {n}-qubit bootstrap ('mle', {n_points} resamples, RrhoR-{MLE_ITERS}): median hs "
        f"{float(dists.median()):.4e}")
    return _kron_clip_row(povm1, gen)


def _kron_clip_row(povm1, gen):
    """w8-rhor256's kron bootstrap at KRON_CLIP_ROW: the W state, 'mle-rhor'
    from lin starts, kron_core's own chunks. Raises unless the lin starts
    clip in CLIP_LAUNCHES_PER_CHUNK psd_clip launches a chunk; returns the
    launches."""
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.tomography import kron_core

    n, n_points = KRON_CLIP_ROW
    ket = torch.zeros(2**n, dtype=torch.complex128)
    ket[[1 << k for k in range(n)]] = 1 / math.sqrt(n)
    truth = qtt.Qobj(ket.numpy(), is_ket=True).bloch_tensor(povm1.device, povm1.dtype)
    gen.manual_seed(120)
    center = kron_core.kron_estimate_lin(kron_core.kron_simulate(gen, povm1, truth, N_SHOTS),
                                         povm1, n)
    # kron_bootstrap_distances' chunks when none is given
    chunk = max(1, min(n_points, kron_core.CHUNK_COUNT_ENTRIES
                       // (povm1.shape[0] * povm1.shape[1]) ** n))
    chunks = -(-n_points // chunk)
    torch.cuda.synchronize()
    kernels.psd_clip.launches = 0
    dists = kron_core.kron_bootstrap_distances(
        gen, center, povm1, n, N_SHOTS, n_points=n_points, method="mle-rhor", max_iter=MLE_ITERS)
    launches = kernels.psd_clip.launches
    if not bool(torch.isfinite(dists).all()):
        raise AssertionError(f"the {n}-qubit W-state bootstrap's distances are not finite")
    if launches != CLIP_LAUNCHES_PER_CHUNK * chunks:
        raise AssertionError(f"the {n}-qubit W-state bootstrap ran {chunks} chunks and {launches} "
                             f"psd_clip launches, not {CLIP_LAUNCHES_PER_CHUNK} per chunk")
    log(f"    {n}-qubit W-state bootstrap ('mle-rhor', {n_points} resamples in {chunks} chunks "
        f"of up to {chunk}, RrhoR-{MLE_ITERS}): median hs {float(dists.median()):.4e}; psd_clip "
        f"launches {launches}")
    return launches


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
    nll = {}
    for method in ("lifp", "states", "dys", "pgdb"):
        est = tmg.point_estimate(method)
        hs = float(qtt.hs_dst(est.choi, truth))
        nll[method] = float(tmg._nll(est.choi.bloch))
        log(f"    2 qubits float64 {method:6s}: hs to the true Choi {hs:.4e} (limit "
            f"{PROC_SMALL_HS_LIMIT}), NLL {nll[method]:.6f}")
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
    return launches


def _process_flagship():
    """Phase 8, part 4: bench.py's 4-qubit process bootstrap on the card."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops import paulis

    n, shots, n_points = PROC_FLAGSHIP
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matrix products are on; the Newton-Schulz chain needs them off")
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=7)  # default device, float32
    tmg.experiment(shots)
    center = tmg.point_estimate("lifp")
    hs_truth = float(qtt.hs_dst(center.choi, tmg.channel.choi))
    log(f"    ProcessTomograph(depolarizing(0.1, {n})) on {tmg.device} ({tmg.dtype}): "
        f"{len(tmg.tomographs)} inputs, counts {tmg.results.shape}; point_estimate('lifp') "
        f"CPTP {center.is_cptp(atol=1e-3, verbose=False)}, hs to the true Choi {hs_truth:.4e}")
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

    # two seeds, each a new interval
    quantiles = []
    levels = (0.5, 0.9)
    for seed in (9, 10):
        interval = qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        interval.setup()
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        sample = interval.distances
        if sample.shape != (n_points,) or not np.all(np.isfinite(sample)):
            raise AssertionError("process bootstrap distances not finite or of the wrong shape")
        quantiles.append(interval(levels)[0])
        log(f"    BootstrapProcessInterval(lifp + CPTP, {n_points} resamples), seed {seed}: "
            f"hs at {levels} {[float(x) for x in quantiles[-1]]}, median "
            f"{float(np.median(sample)):.4e}, peak memory {peak_mib:.1f} MiB")
        if not PROC_MEDIAN_BAND[0] <= float(np.median(sample)) <= PROC_MEDIAN_BAND[1]:
            raise AssertionError(
                f"process bootstrap median {np.median(sample)} outside {PROC_MEDIAN_BAND}")
    spread = float(np.max(np.abs(quantiles[0] - quantiles[1]) / quantiles[1]))
    log(f"    quantiles of the two seeds differ by {spread:.3%} (limit 10%)")
    if not spread <= 0.10:
        raise AssertionError(f"the two seeds' quantiles differ by {spread}")

    # every resampled Choi matrix of one call
    interval = qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=11, channel=center)
    gen = torch.Generator(device=tmg.device)
    gen.manual_seed(11)
    chois = interval.estimate(interval.simulate(gen))
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
    return tmg


def _process_eigh_row(card):
    """Phase 8, part 5: a bootstrap on the 'eigh' engine (the default below
    4 qubits), one psd_project launch per Dykstra iteration, whether the
    iteration ran eagerly or as a replay of the step's CUDA graph; peak
    memory and the launches, held to the steps (`iters` on the program's
    `qt.dykstra` spans). Returns the launches."""
    import numpy as np

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.ops import kernels
    from quantpy_tpu_torch.utils import profiling

    n, shots, n_points = PROC_EIGH_ROW
    tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=5)
    tmg.experiment(shots)
    tmg.point_estimate("lifp")
    interval = qtt.BootstrapProcessInterval(tmg, n_points=n_points, key=6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.psd_project.launches = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        interval.setup()
    launches = kernels.psd_project.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    dykstra = [s.counts for s in profiling.recorded() if s.name == "qt.dykstra"]
    steps, replays = (sum(c.get(k, 0) for c in dykstra) for k in ("iters", "graph"))
    if not (steps and launches == PSD_LAUNCHES_PER_STEP * steps):
        raise AssertionError(f"the {n}-qubit 'eigh' bootstrap ran {steps} Dykstra steps "
                             f"and {launches} psd_project launches, not "
                             f"{PSD_LAUNCHES_PER_STEP} per step")
    if not np.all(np.isfinite(interval.distances)):
        raise AssertionError(f"{n}-qubit process bootstrap distances are not finite")
    log(f"    {n}-qubit process bootstrap on the 'eigh' engine ({n_points} resamples, {shots} "
        f"shots, up to 2000 Dykstra iterations of a batched {4**n}-dim eigh): median hs "
        f"{float(np.median(interval.distances)):.4e}, peak memory {peak_mib:.1f} MiB on {card}; "
        f"{steps} Dykstra steps ({replays} replayed from a CUDA graph), psd_project launches "
        f"{launches}")
    return launches


def phase8_process(card):
    """Returns (rhor_mle launches, the flagship's tomograph, psd_project
    launches of the 'eigh' bootstrap)."""
    log("[8] process tomography on the card")
    launches = _process_small_checks()
    tmg = _process_flagship()
    psd_launches = _process_eigh_row(card)
    return launches, tmg, psd_launches


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
    up the row's intervals and returns {name: interval}. A first call runs
    under DeviceAudit, with every polytope's LP capped at `lp_cap`
    iterations; the second is read. Returns the second call's intervals and
    its recorded LP solves (LPRecorder)."""
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


def _setup(iv):
    iv.setup()
    return iv


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


def _read(name, iv, banded=False, solves=None):
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
    log(f"      {name}: {text} at cl {ANALYTIC_LEVELS}{extra}")
    if not ok:
        raise AssertionError(f"{name}: values fail the interval checks")
    if hasattr(iv, "lp_iterations"):
        _read_lp(name, solves)


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
            out[f"MomentInterval('{distr}')"] = _setup(qtt.MomentInterval(tmg, distr_type=distr))
        out["MomentFidelityStateInterval"] = _setup(
            qtt.MomentFidelityStateInterval(tmg, target_state=tmg.state))
        out["SugiyamaInterval"] = _setup(qtt.SugiyamaInterval(tmg))
        out["PolytopeStateInterval"] = _setup(qtt.PolytopeStateInterval(tmg, n_points=n_points))
        return out

    m, p, dim = tmg.povm_matrix.shape
    log(f"    state, dense: GHZ({n}), proj-set ({m} x {p}, K = {m * p}), {shots} shots, "
        f"float32; polytope {n_points} margins x 2 directions of {m * p} constraints x "
        f"{dim - 1} variables")
    rows, solves = _row(f"the dense GHZ-{n} row", build_dense, card, lp_cap=AUDIT_LP_ITERS)
    for name, iv in rows.items():
        _read(name, iv, banded=name.startswith(("MomentFidelity", "Polytope")), solves=solves)

    # float32 against float64 on the same counts at the JAX package's
    # test size (test_polytope_interval_f32_vs_x64)
    from quantpy_tpu_torch import interop

    twin64 = interop.tomograph_from_arrays(**interop.to_numpy(tmg), dtype=torch.float64)
    cl = np.linspace(0.3, 0.9, 6)
    got = {}
    for label, t in (("float32", tmg), ("float64", twin64)):
        iv = qtt.PolytopeStateInterval(t, n_points=ANALYTIC_F64_POINTS)
        (lo, hi), _ = iv(cl)
        got[label] = np.concatenate([lo, hi])
        log(f"      PolytopeStateInterval(n_points={ANALYTIC_F64_POINTS}) in {label}: "
            f"lp_iterations {iv.lp_iterations}")
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
        return {
            "MomentInterval (kron_l2_moments)": _setup(qtt.MomentInterval(tmg)),
            "SugiyamaInterval (kron_sugiyama_c_alpha)": _setup(qtt.SugiyamaInterval(tmg)),
            "MomentFidelityStateInterval": _setup(
                qtt.MomentFidelityStateInterval(tmg, target_state=tmg.state)),
            "PolytopeStateInterval (solve_lp_batch_kron)": _setup(
                qtt.PolytopeStateInterval(tmg, n_points=n_points)),
        }

    shape = tmg.results.shape
    log(f"    state, kron: GHZ({n}) in kron mode, counts {shape}, {shots} shots, float32; "
        f"polytope {n_points} margins of {shape[0] * shape[1]} constraints x {4**n - 1} "
        "variables")
    rows, solves = _row(f"the kron GHZ-{n} row", build_kron, card, lp_cap=AUDIT_LP_ITERS)
    for name, iv in rows.items():
        _read(name, iv, banded=name.startswith(("MomentFidelity", "Polytope")), solves=solves)


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
        out = {"MomentInterval (per-state Grams)": _setup(qtt.MomentInterval(tmg)),
               "MomentFidelityProcessInterval": _setup(qtt.MomentFidelityProcessInterval(tmg))}
        for kind in ("moment", "sugiyama"):
            out[f"HolderInterval('{kind}'), {n_in} children"] = _setup(
                qtt.HolderInterval(tmg, kind=kind))
        out["PolytopeProcessInterval (solve_lp_batch_factors)"] = _setup(
            qtt.PolytopeProcessInterval(tmg, n_points=n_points))
        return out

    log(f"    channel: depolarizing(0.1, {n}), {n_in} proj4 inputs, proj-set ({m} x {p}), "
        f"{shots} shots, float32; polytope {n_points} margins of ({n_in} x {m * p}) "
        f"constraints x {dim * (dim - 1)} variables, two-factor")
    rows, solves = _row(f"the {n}-qubit channel row", build, card, lp_cap=AUDIT_LP_ITERS)
    for name, iv in rows.items():
        _read(name, iv, banded=name.startswith(("MomentFidelity", "Polytope")), solves=solves)
    exact = rows["MomentInterval (per-state Grams)"]

    def build_stochastic():
        return {"MomentInterval (channel_l2_moments_kron, 128 probes)":
                _setup(qtt.MomentInterval(tmg))}

    saved = interval_mod._CHANNEL_EXACT_GRAM_MAX
    interval_mod._CHANNEL_EXACT_GRAM_MAX = 1
    try:
        stochastic, _ = _row(f"the {n}-qubit stochastic channel row", build_stochastic, card)
    finally:
        interval_mod._CHANNEL_EXACT_GRAM_MAX = saved
    (name, iv), = stochastic.items()
    _read(name, iv)
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
        cov = run(n_trials)
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"    {what}, 18 levels in [0.05, 0.99], {n_trials} trials: peak memory "
            f"{peak:.1f} MiB on {card}")
        log(f"      coverage {[round(float(c), 4) for c in cov]}")
        if not (np.all(cov >= levels - 0.05) and np.all(np.diff(cov) >= -0.05)):
            raise AssertionError(f"{what}: coverage under its levels or falling: {cov}")


def phase9_intervals(card):
    log("[9] the analytic confidence intervals on the card")
    _analytic_small_checks()
    _analytic_state_rows(card)
    _analytic_channel_rows(card)
    _coverage_rows(card)


# -- phase 10: the MCMC intervals -----------------------------------------------


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
    Python dispatch would slow it): no kernel launch. Returns run()'s value;
    the peak memory counts from its start."""
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
    out = run()
    from quantpy_tpu_torch.ops import kernels

    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    log(f"    {what}: rhor_mle / rhor_mle_flat launches {launched} (the unaudited run)")
    if launched != (0, 0):
        raise AssertionError(f"{what} launched an RrhoR kernel: {launched}")
    return out


def _print_chain_row(name, iv, card, levels=(0.5, 0.9)):
    import numpy as np

    dist, _ = iv(np.asarray(levels))
    if not (np.all(np.isfinite(dist)) and np.all(np.diff(dist) >= 0)):
        raise AssertionError(f"{name}: distances {dist} not finite and non-decreasing")
    log(f"      {name}: acceptance {iv.acceptance_rate:.4f}, step {iv.chain.step:.4g}; R-hat "
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

    iv = _audited("MHMCStateInterval", state_interval, allowed, **MCMC_AUDIT_STATE)
    log(f"    (b) MHMCStateInterval on GHZ({N_QUBITS}), proj-set, {N_SHOTS} shots, float32: "
        f"n_points {n_points}, burn_steps {burn}, adapt_step, {n_chains} chains")
    _print_chain_row("MHMCStateInterval", iv, card)

    def bme(**small):
        return qtt.bayesian_mean_estimate(tmg, key=32, **small)

    rho, radius, diag = _audited("bayesian_mean_estimate", bme, allowed, **MCMC_AUDIT_BME)
    hs_bme = float(qtt.hs_dst(rho, tmg.state))
    hs_rhor = float(qtt.hs_dst(est, tmg.state))
    log(f"    (c) bayesian_mean_estimate (8 chains x 500 samples, thinning 2, burn 500, adapt): "
        f"acceptance {diag['acceptance_rate']:.4f}, step {diag['step']:.4g}; credible radius (0.9) "
        f"{radius:.6f}; hs to the true state: posterior mean {hs_bme:.6f}, RrhoR estimate "
        f"{hs_rhor:.6f}")
    if not (rho.is_density_matrix(verbose=False) and 0 < radius < 1 and hs_bme < 0.1):
        raise AssertionError(f"the posterior mean is off: radius {radius}, hs {hs_bme}")


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

    iv, samples = _audited(f"the {n}-qubit kraus-MALA interval", posterior, allowed,
                           **MCMC_AUDIT_PROCESS)
    log(f"    (d) MHMCProcessInterval, depolarizing(0.15, {n}), proj-set, {shots} shots, "
        f"float32: anchored kraus-MALA, whitened, mode_seek 500, 32 curvature probes, "
        f"{n_chains} chains, thinning {thinning}, {n_points} points, burn {burn} (the example's "
        "600 points and 4,000 burn-in steps cut to fit phase 10's time), adapt")
    dist = _print_chain_row("kraus-MALA", iv, card)
    _check_cptp_samples("kraus-MALA", samples)
    boot = qtt.BootstrapProcessInterval(tmg, n_points=MCMC_BOOT_POINTS, key=8, cp_engine="ns")
    boot_dist, _ = boot(np.array([0.5, 0.9]))
    log(f"      beside BootstrapProcessInterval({MCMC_BOOT_POINTS} resamples, the 'ns' engine) d50/d90 "
        f"{[round(float(v), 6) for v in boot_dist]}; chain / bootstrap "
        f"{[round(float(a / b), 4) for a, b in zip(dist, boot_dist)]}")

    n4 = tmg4.channel.n_qubits
    seek, burn4, points4 = MCMC_FOUR

    def four(n_points=points4, burn_steps=burn4, mode_seek=seek, curv_probes=32):
        return _setup(qtt.MHMCProcessInterval(
            tmg4, n_points=n_points, burn_steps=burn_steps, parametrization="kraus",
            proposal="mala", mode_seek=mode_seek, curv_probes=curv_probes, key=9))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        iv4 = _audited(f"the {n4}-qubit kraus-MALA chain", four, allowed, **MCMC_AUDIT_FOUR)
    fired = any(issubclass(w.category, RuntimeWarning) and "NOT converged" in str(w.message)
                and f"R-hat {iv4.r_hat:.2f}" in str(w.message) for w in caught)
    log(f"    (e) {n4} qubits, depolarizing(0.1, {n4}), {len(tmg4.tomographs)} inputs, proj-set, "
        f"2000 shots, float32: anchored kraus-MALA, mode_seek {seek}, burn {burn4}, "
        f"{points4} points, 1 chain, no adaptation")
    _print_chain_row("kraus-MALA", iv4, card)
    log(f"      the non-convergence RuntimeWarning fired: {fired}")
    _anchored_rounding_field(iv4)

    def projected(n_points=MCMC_PROJECTED_STEPS):
        return _setup(qtt.MHMCProcessInterval(tmg4, n_points=n_points, burn_steps=0,
                                              proposal="mala", step=1e-3, key=10))

    iv4b = _audited(f"the {n4}-qubit projected 'bloch' MALA chain", projected, allowed,
                    n_points=1)
    log(f"      projected-target 'bloch' MALA (K-FAC whitened, NS Dykstra 100 with autograd), "
        f"{MCMC_PROJECTED_STEPS} points: acceptance "
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


def _mcmc_holder_and_metrics(allowed):
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

    iv = _audited("HolderInterval('mhmc')", holder, allowed, process=small, n_points=8,
                  burn_steps=8)
    dist, _ = iv(np.asarray(ANALYTIC_LEVELS))
    log(f"    (f) HolderInterval('mhmc'), depolarizing(0.1, 2), {len(tmg.tomographs)} children, "
        f"n_points {n_points}, burn {burn}, float32: radii "
        f"{[round(float(v), 6) for v in dist]} at cl {ANALYTIC_LEVELS}")
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
        levels = _audited(what, run, allowed, n_points=8, burn_steps=8)
        log(f"    (g) {what}, 2 experiments: achieved levels "
            f"{[round(float(v), 4) for v in levels]}")
        if not (levels.shape == (2,) and np.all((levels >= 0) & (levels <= 1))):
            raise AssertionError(f"{what}: levels {levels} outside [0, 1]")


def phase10_mcmc(card, tmg, est, tmg4):
    log("[10] the MCMC intervals on the card")
    log("    (a) 2 qubits, float64, the card against the CPU")
    _mcmc_small_checks()
    allowed = _allowed_wide_ops()
    log(f"    float64 operations of the anchored NLL's reduction, the only ones allowed in the "
        f"float32 rows: {sorted(allowed)}")
    _mcmc_state_rows(card, tmg, est, allowed)
    _mcmc_process_rows(card, tmg4, allowed)
    _mcmc_holder_and_metrics(allowed)


def _counted(what, fn, tally, b1=None):
    """Run fn() once as a counted run of phase 11's main path: every kernel's
    count set to 0 just before and read just after. rhor_mle_flat must not
    launch, rhor_mle `b1` times where given. Adds the rhor_mle launches to
    `tally` and returns (fn's value, rhor_mle launches)."""
    from quantpy_tpu_torch.ops import kernels

    _reset_launches()
    out = fn()
    b1_n, b2_n = kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches
    tally[0] += b1_n
    if b2_n:
        raise AssertionError(f"{what} launched rhor_mle_flat {b2_n} times")
    if b1 is not None and b1_n != b1:
        raise AssertionError(f"{what} launched rhor_mle {b1_n} times, expected {b1}")
    return out, b1_n


def _audited_rerun(what, fn):
    """fn() once more under the device audit: raise if an operation ran off
    DEVICE; return the aten ops seen."""
    audit = DeviceAudit()
    with audit:
        fn()
        torch.cuda.synchronize()
    if audit.off_device:
        raise AssertionError(f"{what}: operations off {DEVICE}: {sorted(audit.off_device)}")
    return audit.n_ops


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


def _cli_invocation(what, module, kind, path, argv, tally, timer, b1):
    """One console invocation, `module.main(["-i", path, ...argv])`, on the
    card: the counted run in `timer`'s stage `what`, its output checked,
    then an audited rerun. Returns the output."""
    out_path = f"{path}.{what.replace(' ', '_')}.out.json"
    args = ["-i", path, "-o", out_path, "--device", DEVICE] + argv

    def invoke():
        with timer.stage(what):
            module.main(args)

    _, launched = _counted(what, invoke, tally, b1)
    with open(out_path) as fp:
        out = json.load(fp)
    _check_cli_output(what, out, kind, len(CLI_LEVELS))
    n_ops = _audited_rerun(what, lambda: module.main(args))
    log(f"    {what}: audited rerun {n_ops} aten ops, all on {DEVICE}; rhor_mle launches "
        f"{launched}; hs radii "
        f"{[round(v, 6) for v in out['hs_radius']]}, fidelity band "
        f"[{out['fidelity_min'][-1]:.6f}, {out['fidelity_max'][-1]:.6f}] at "
        f"{CLI_LEVELS[-1]}")
    return out


def _write_record(path, doc):
    with open(path, "w") as fp:
        json.dump(doc, fp)
    log(f"    record {Path(path).name}: {Path(path).stat().st_size / 2**20:.1f} MiB")
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
                        ["--method", "mle-rhor"] + argv, tally, timer, b1)
    # the console entry as a user runs it, in a process of its own
    out_path = f"{tmp}/console.out.json"
    res = subprocess.run(
        [sys.executable, "-m", "quantpy_tpu_torch.cli.state_interval", "-i", path, "-o",
         out_path, "--no-ci", "--device", DEVICE],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    if res.returncode != 0:
        raise AssertionError(f"python -m quantpy_tpu_torch.cli.state_interval failed:\n"
                             f"{res.stderr[-2000:]}")
    with open(out_path) as fp:
        console = json.load(fp)["state"]
    here = state_interval.run(state_interval.load_input(path), no_ci=True, device=DEVICE)
    gap = float(np.max(np.abs(np.subtract(console, here["state"]))))
    log(f"    python -m quantpy_tpu_torch.cli.state_interval --no-ci in a process of its own: "
        f"its 'lin' state against this process's: max |diff| {gap:.3e}")
    if not gap <= 1e-6:
        raise AssertionError(f"the console entry's state differs from run()'s by {gap}")
    return path


def _cli_kron_rows(tmp, tally, timer):
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
                        ["--method", "mle-rhor"] + argv, tally, timer, 0)


def _cli_process_rows(tmg4, tmp, tally, timer):
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
                        ["--method", "lifp"] + argv, tally, timer, 0)


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


def _utility_rows(path, tally, timer):
    """Phase 11, part (e): resumable_bootstrap on (a)'s tomograph, the
    StageTimer's stages of (a) to (c) and a trace of one bootstrap call."""
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

    full, _ = _counted("the uninterrupted resumable_bootstrap",
                       lambda: boot("full.npz", n_points), tally, n_chunks * B1_PER_F32_BATCH)
    _counted("the interrupted resumable_bootstrap", lambda: boot("resumed.npz", n_before * chunk),
             tally, n_before * B1_PER_F32_BATCH)
    saved = ChunkedAccumulator(str(tmp / "resumed.npz"))
    resumed, _ = _counted("the resumed resumable_bootstrap", lambda: boot("resumed.npz", n_points),
                          tally, (n_chunks - n_before) * B1_PER_F32_BATCH)
    gap = float(np.max(np.abs(resumed - full)))
    log(f"    (e) resumable_bootstrap, {n_points} resamples of RrhoR-{MLE_ITERS} in chunks of "
        f"{chunk} on (a)'s tomograph, {n_chunks} .npz flushes: interrupted after "
        f"{saved.n_chunks} chunks ({saved.n_done} samples) and resumed, max |diff| to the "
        f"uninterrupted run {gap:.3e}; median {np.median(full):.4e}")
    if not (full.shape == (n_points,) and np.all(np.isfinite(full)) and gap <= 1e-7):
        raise AssertionError(f"the resumed bootstrap differs from the uninterrupted one: {gap}")
    stages = timer.report()
    log(f"    StageTimer over (a)-(c): stages {sorted(stages)}")
    if len(stages) != 8 or not all(math.isfinite(v) and v > 0 for v in stages.values()):
        raise AssertionError(f"the StageTimer reports {stages}, not (a)-(c)'s 8 invocations")
    trace_dir = tmp / "trace"
    bloch = tmg._tensor(tmg.reconstructed_state.bloch)
    gen = torch.Generator(device=tmg.device)
    gen.manual_seed(5)
    with trace(str(trace_dir), device=DEVICE):
        bootstrap_core.bootstrap_distances(
            gen, bloch, tmg._tensor(tmg.povm_matrix), tmg._tensor(tmg.n_measurements),
            n_points=chunk, method="mle-rhor", max_iter=MLE_ITERS)
    files = list(trace_dir.glob("*.pt.trace.json"))
    text = files[0].read_text() if len(files) == 1 else ""
    named = "rhor_mle_kernel" in text
    log(f"    trace() around one {chunk}-resample bootstrap_distances call: "
        f"{len(text) / 2**20:.2f} MiB Chrome trace; names the rhor_mle kernel: {named}")
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
        _, launched = _counted(what, run, tally)
        with _short_loops(), contextlib.redirect_stdout(None):
            n_ops = _audited_rerun(what, run)
        log(f"    {what}: rhor_mle launches {launched}; audited rerun {n_ops} aten ops")


def phase11_entry_points(card, tmg, tmg4):
    """The user entry points on the card; returns the rhor_mle launches of
    its counted runs."""
    import tempfile

    from quantpy_tpu_torch.utils import StageTimer

    log("[11] the user entry points on the card")
    tally = [0]
    timer = StageTimer(device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        path = _cli_state_rows(card, tmg, tmp, tally, timer)
        _cli_kron_rows(tmp, tally, timer)
        _cli_process_rows(tmg4, tmp, tally, timer)
        _cli_small_checks()
        _utility_rows(path, tally, timer)
    _example_rows(card, tally)
    log(f"    phase 11: rhor_mle launches in its counted runs {tally[0]}, rhor_mle_flat none")
    return tally[0]


# -- phase 12: the mesh layer -----------------------------------------------------


def _mesh(k):
    from quantpy_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[DEVICE] * k)


def _mesh_resample_row(card, tmg, est, tally):
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

    d4, launched = _counted(f"the {k}-shard bootstrap", lambda: call(k), tally,
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
        f"{card} ({per} per shard), RrhoR-{MLE_ITERS}, float32: rhor_mle launches {launched}; "
        f"median hs {median:.4e}; against the {k} single-device "
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
    median = _check_distances(call(1).cpu().numpy(), n_points, "the 1-shard bootstrap")
    log(f"    1 shard: median hs {median:.4e}")


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
    peak = {}

    def peaked(name, fn):
        result = fn()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
        return result

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts = peaked("simulate", lambda: sharded_kron_simulate(mesh, 120 + n, povm1, truth,
                                                              N_SHOTS))
    lin = peaked("lin", lambda: sharded_kron_estimate_lin(mesh, counts, povm1, n))
    mle = peaked("mle", lambda: sharded_kron_estimate_mle_rhor(
        mesh, counts, povm1, n, init_bloch=lin, max_iter=MLE_ITERS))
    n_counts = math.prod(counts.shape)
    shard_shape = tuple(counts.shards[0].shape)
    hs = {k: float(bootstrap_core._distance_batch("hs", v, truth, n))
          for k, v in (("lin", lin), ("mle", mle))}
    gathered = counts.gather()
    del counts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    single = peaked("single", lambda: kron_core.kron_estimate_mle_rhor(
        gathered, povm1, n, init_bloch=lin, max_iter=MLE_ITERS))
    del gathered
    gap = float((single - mle).abs().max())
    log(f"    (b) GHZ-{n}, proj-set, {N_SHOTS} shots per POVM, float32, over {MESH_SHARDS} "
        f"logical shards on {card}: counts {n_counts * 4 / 1e9:.2f} GB born split in shards of "
        f"{shard_shape}")
    log(f"      peak after simulate {peak['simulate']:.2f} GiB, lin {peak['lin']:.2f} GiB, "
        f"MLE-{MLE_ITERS} {peak['mle']:.2f} GiB; hs to the truth lin {hs['lin']:.4e}, MLE "
        f"{hs['mle']:.4e}")
    log(f"      the single-device kron_core MLE-{MLE_ITERS} on the gathered counts: peak "
        f"{peak['single']:.2f} GiB; sharded vs single max |diff| {gap:.3e} (limit "
        f"{MESH_MATCH_TOL:.0e})")
    if not 0 <= hs["mle"] < TRUTH_HS_LIMIT:
        raise AssertionError(f"{n}-qubit sharded MLE hs to the truth {hs['mle']}")
    if not gap <= MESH_MATCH_TOL:
        raise AssertionError(f"the sharded and single-device {n}-qubit MLE differ by {gap}")


def _mesh_chain_rows(tmg, est):
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
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # short-chain R-hat
                iv = build()
                dist, _ = iv(cl)
            out[name] = (np.asarray(dist), iv)
        (d_mesh, iv_mesh), (d_local, _) = out["mesh"], out["local"]
        if what.startswith("MHMC"):
            rel = float(np.max(np.abs(d_mesh - d_local) / d_local))
        else:
            m, m_v = float(np.median(d_mesh)), float(np.median(d_local))
            rel = abs(m - m_v) / max(m, m_v)
        log(f"    (c) {what}, {iv_mesh.n_chains} chains over {MESH_SHARDS} shards: acceptance "
            f"{iv_mesh.acceptance_rate:.4f}; distances {np.round(d_mesh, 6).tolist()} vs local "
            f"{np.round(d_local, 6).tolist()}; relative gap {rel:.4f} (limit {rel_limit})")
        if not (np.all(np.isfinite(d_mesh)) and 0 < iv_mesh.acceptance_rate <= 1
                and rel < rel_limit):
            raise AssertionError(f"{what}: the mesh chains disagree with the local run")


def _mesh_process_and_coverage_rows(tmg4):
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
        d = sharded_process_bootstrap_distances(meshes[size], 13, *args, n_points=n_points,
                                                cp="ns", cptp_iter=iters).cpu().numpy()
        if d.shape != (n_points,) or not np.all(np.isfinite(d)):
            raise AssertionError("sharded process bootstrap distances are not finite")
        medians[size] = float(np.median(d))
        log(f"    (d) process bootstrap, {tmg4.channel.n_qubits} qubits x "
            f"{len(tmg4.tomographs)} inputs, {n_points} resamples over {size} shard(s), lifp + "
            f"{iters} NS-Dykstra iterations: median hs {medians[size]:.4e}")
    spread = abs(medians[k] - medians[1]) / medians[1]
    if not (PROC_MEDIAN_BAND[0] <= medians[k] <= PROC_MEDIAN_BAND[1] and spread <= 0.10):
        raise AssertionError(f"the sharded process bootstrap medians are off: {medians}")

    n, shots, trials = COVERAGE_QST
    levels = np.linspace(0.05, 0.99, 18)
    problem = verification.qst_problem(qtt.GHZ(n), shots)
    cov = {size: sharded_coverage(meshes[size], 98, problem, levels, trials) for size in (k, 1)}
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
    log(f"    (d) coverage of GHZ({n}), {shots} shots, {trials} trials: "
        f"{np.round(cov[k], 4).tolist()}; {k} vs 1 shard max |diff| {gap:.4f} "
        f"(limit {gap_limit:.3f}); at {exact} trials the hits equal the per-shard "
        f"coverage_hits: {equal}")
    if not (np.all(cov[k] >= levels - 0.05) and gap <= gap_limit and equal):
        raise AssertionError("the sharded coverage is off")


def _mesh_example_row(tally):
    """Phase 12, part (e): quantpy_tpu_torch.examples.multichip on the card,
    counted, then rerun under the device audit."""
    import io

    from quantpy_tpu_torch.examples import multichip

    shards = len(multichip._mesh_devices(torch.device(DEVICE))[0])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, launched = _counted("multichip.main", lambda: multichip.main(["--device", DEVICE]),
                               tally, b1=shards * B1_PER_F32_BATCH)
    for line in buf.getvalue().splitlines():
        log(f"      | {line}")
    with contextlib.redirect_stdout(None):
        n_ops = _audited_rerun("multichip", lambda: multichip.main(["--device", DEVICE]))
    log(f"    (e) multichip.main: rhor_mle launches {launched} ({shards} shards); audited rerun "
        f"{n_ops} aten ops, all on the card")


def phase12_mesh(card, tmg, est, tmg4):
    """The mesh layer on the card; returns the rhor_mle launches of its
    counted runs."""
    log(f"[12] the mesh layer: {MESH_SHARDS} logical shards on one card")
    tally = [0]
    _mesh_resample_row(card, tmg, est, tally)
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
    _mesh_chain_rows(tmg, est)
    _mesh_process_and_coverage_rows(tmg4)
    _mesh_example_row(tally)
    log(f"    phase 12: rhor_mle launches in its counted runs {tally[0]}, rhor_mle_flat none")
    return tally[0]


# -- phase 13: the port's benchmark and entry points ------------------------


def _bench_row():
    """Phase 13, part (a): quantpy_tpu_torch.bench.main in-process at full
    width, its JSON line checked; returns its (rhor_mle, rhor_mle_flat)
    launches."""
    import io

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch import bench
    from quantpy_tpu_torch.ops import kernels

    out, err = io.StringIO(), io.StringIO()
    _reset_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = bench.main(["--device", DEVICE])
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


def _entry_row():
    """Phase 13, part (b): entry()'s flagship bootstrap round on the card;
    returns its rhor_mle launches."""
    import numpy as np

    from quantpy_tpu_torch import entry
    from quantpy_tpu_torch.ops import kernels

    fn, args = entry.entry(device=DEVICE)
    _reset_launches()
    d = fn(*args)
    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    if d.device.type != DEVICE:
        raise AssertionError(f"entry()'s distances are on {d.device}")
    median = _check_distances(d.cpu().numpy(), ENTRY_POINTS, "entry()")
    log(f"    (b) entry(): fn(*args) {ENTRY_POINTS} distances, median {median:.4e}, finite "
        f"{bool(np.isfinite(d.cpu().numpy()).all())}; rhor_mle / rhor_mle_flat launches "
        f"{launched}")
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
    with audit, contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(MESH_SHARDS, devices=[torch.device(DEVICE, 0)] * MESH_SHARDS)
        torch.cuda.synchronize()
    launched = (kernels.rhor_mle.launches, kernels.rhor_mle_flat.launches)
    for line in buf.getvalue().splitlines():
        log(f"      | {line}")
    # the state bootstrap's shards and its single-device twin, one f32
    # 'mle-rhor' batch each; no other stage reaches a kernel
    want = (B1_PER_F32_BATCH * (MESH_SHARDS + 1), 0)
    log(f"    (c) dryrun_multichip({MESH_SHARDS}) on {card} under the audit ({audit.n_ops} aten "
        f"ops, off the card: {sorted(audit.off_device) or 'none'}); rhor_mle / rhor_mle_flat "
        f"launches {launched} (expected {want})")
    if audit.off_device:
        raise AssertionError(f"the dry run ran operations off the card: {sorted(audit.off_device)}")
    if launched != want:
        raise AssertionError(f"the dry run launched {launched}, expected {want}")
    return launched[0]


def phase13_bench_and_entry(card):
    """The port's benchmark and entry points on the card; returns
    the (rhor_mle, rhor_mle_flat) launches of its counted runs."""
    log("[13] the port's benchmark (quantpy_tpu_torch.bench) and entry points "
        "(quantpy_tpu_torch.entry)")
    b1, b2 = _bench_row()
    b1 += _entry_row()
    b1 += _dryrun_row(card)
    log(f"    phase 13: launches in its counted runs: rhor_mle {b1}, rhor_mle_flat {b2}")
    return b1, b2


# -- phase 14: the rest of the surface ------------------------------------------


def _chain_flagship_row(tmg, est):
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
    log(f"    (a) {N_POINTS} x {tuple(probs.shape[1:])} counts from phase 3's GHZ-{n} "
        f"estimate, {N_SHOTS} shots per POVM, {dtype}: the chain draw ({probs.shape[-1] - 1} "
        f"binomial passes) and the binary split ({(probs.shape[-1] - 1).bit_length()} passes)")
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
    peaks, exact row totals, per-outcome sums within 5 standard
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
        counts = draw(gen, povm1, truth, N_SHOTS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if counts.device.type != DEVICE or counts.shape != (3**n, 2**n):
            raise AssertionError(f"{name} returned {tuple(counts.shape)} on {counts.device}")
        sums, exact = _kron_sums(counts, N_SHOTS)
        rows[name] = (peak, sums, exact)
        del counts
    probs = kron_core.kron_probs(povm1.double(), n, truth.double())
    probs = probs / probs.sum(-1, keepdim=True)
    var = (N_SHOTS * probs * (1 - probs)).sum(-2)
    expected = (N_SHOTS * probs).sum(-2)
    del probs
    (p_f, sum_f, ok_f), (p_c, sum_c, ok_c) = rows.values()
    z_pair = float(((sum_f - sum_c).abs() / (2 * var).sqrt().clamp(min=1e-300)).max())
    z_truth = max(float(((s - expected).abs() / var.sqrt().clamp(min=1e-300)).max())
                  for s in (sum_f, sum_c))
    m0 = 3 ** group_sizes(n)[0]
    log(f"    (b) GHZ-{n}, proj-set, {N_SHOTS} shots per POVM, float32 on {card}: "
        f"{3**n} x {2**n} counts ({3**n * 2**n * 4 / 1e9:.2f} GB)")
    log(f"      kron_simulate peak {p_f:.2f} GiB; kron_simulate_chunked ({m0} blocks) peak "
        f"{p_c:.2f} GiB; row totals exact: {ok_f}, {ok_c}; "
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
        moments = kron_analytic.channel_l2_moments_kron(
            tmg._states1_t, tmg._povm1, n, freq3, n_trials, state_chunk=chunk, probes=probes,
            device=dev)
        out[chunk] = (moments, torch.cuda.max_memory_allocated() / 2**20)
    (m_a, p_a), (m_b, p_b) = out.values()
    rel = max(abs(a - b) / abs(b) for a, b in zip(m_a, m_b))
    log(f"    (c) channel_l2_moments_kron on depolarizing(0.1, {n}), {len(freq3)} inputs, "
        f"{shots} shots, {n_probes} probes, float64 on {card}: state_chunk {chunks[0]} peak "
        f"{p_a:.1f} MiB, state_chunk {chunks[1]} peak {p_b:.1f} MiB; (mean, variance) "
        f"({m_b[0]:.9e}, {m_b[1]:.9e}), largest relative difference {rel:.3e} (limit "
        f"{SURFACE_CHANNEL_REL:.0e})")
    if not (all(math.isfinite(v) for v in m_a + m_b) and rel <= SURFACE_CHANNEL_REL):
        raise AssertionError(f"the state chunkings disagree: {m_a} against {m_b}")


def _pgdb_host_row():
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

    host = run(DEVICE, process_core.estimate_pgdb_factored_host)
    fused = run(DEVICE, process_core.estimate_pgdb_factored)
    on_cpu = run("cpu", process_core.estimate_pgdb_factored_host)
    gap = float((host - fused).abs().max())
    card_cpu = float((host.cpu() - on_cpu).abs().max())
    log(f"    (d) estimate_pgdb_factored_host, depolarizing(0.1, {n}), {shots} shots, lifp "
        f"warm start, {n_iter} iterations, {cptp_iter} Dykstra iterations, float64: "
        f"max|delta| against estimate_pgdb_factored {gap:.3e}, "
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
    launches = _chain_flagship_row(tmg, est)
    _chunked_kron_row(card)
    _state_chunk_row(card)
    _pgdb_host_row()
    _df32_and_cplx_row(card)
    log(f"    phase 14: rhor_mle launches in its counted runs {launches}, rhor_mle_flat none")
    return launches


def main() -> int:
    card = phase0_device()
    log(card)
    sys.path.insert(0, str(REPO))
    phase1_build()
    measured = phase2_kernel_vs_plain()
    measured[PSD_KERNEL] = phase2_psd_kernel()
    measured[CLIP_KERNEL] = phase2_clip_kernel()
    tmg, est, launches = phase3_main_path(card)
    flat_launches = phase5_flat_path(tmg, est)
    phase6_cholesky_mle()
    clip_launches = phase7_kron(card)
    process_launches, process_tmg, psd_launches = phase8_process(card)
    launches += process_launches
    phase9_intervals(card)
    phase10_mcmc(card, tmg, est, process_tmg)
    launches += phase11_entry_points(card, tmg, process_tmg)
    launches += phase12_mesh(card, tmg, est, process_tmg)
    bench_b1, bench_b2 = phase13_bench_and_entry(card)
    launches += bench_b1
    flat_launches += bench_b2
    launches += phase14_surface(card, tmg, est)
    sources = {
        "rhor_mle": ("quantpy_tpu/ops/kernels.py:289", launches),
        "rhor_mle_flat": ("quantpy_tpu/ops/kernels.py:206", flat_launches),
        PSD_KERNEL: ("none: process_core._eigh_psd_mat's eigh, batched", psd_launches),
        CLIP_KERNEL: ("none: state_core.make_feasible_bloch's eigh, batched", clip_launches),
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
