"""Flagship benchmark of the port: bootstrapped 4-qubit MLE reconstructions
per second on the card (port of the repository's bench.py).

    python -m quantpy_tpu_torch.bench [--device cuda|cpu]

Workload (the reference's own time test, BASELINE.md): GHZ-4, the proj-set
POVM (81 POVMs x 16 outcomes), 10^4 shots per POVM; each resample is a
simulated experiment, 60 RrhoR fixed-point iterations (the lane kernel
`kernels.rhor_mle`, one launch per call in float32 on the card) and the
Hilbert-Schmidt distance to the point estimate. The headline is one
`bootstrap_core.bootstrap_distances` call of N_POINTS resamples: one
build-and-first call, then HEADLINE_REPS calls timed by CUDA events;
`value` is N_POINTS over the best.

The last line of stdout is one JSON object, `bench.py`'s schema:
{"metric", "value", "unit", "vs_baseline", "extras"}; `vs_baseline` is the
speed-up over the reference library's ~18 s per reconstruction
(REFERENCE_REC_PER_SEC, BASELINE.md; a CPU number). `extras` carries
bench.py's keys and four of its own:

- `tflops` and `mfu_f32_pct`: the function's work, 2KD + 6d^3
  multiply-adds per resample-iteration (K = 1296 unpadded, no dense PTM;
  `flops_per_resample`), over the best call, as a share of the card's FP32
  peak read at run time (`fp32_peak_tflops`). bench.py's `mfu_exposed_pct`
  rests on the TPU's vector-unit issue rate and has no counterpart here.
- `state_lin_6q_ms`, `state_boot_6q_mle_rec_s`, `state_scaling_kron`
  (rows with `lin_ms`, `mle60_ms`, `mle_hs`; the 11-qubit row also
  `simulate_s`, one `kron_simulate`, and `simulate_chunked_s`, one
  `kron_simulate_chunked` in 27 blocks, as bench.py times it),
  `state_boot_10q_mle_rec_s`, `kernel_lane_rec_s` and `kernel_flat_rec_s`
  (the flagship call through each RrhoR kernel, in turns; the flat kernel
  is swapped in with `flat_kernel_on_main_path`), `process_boot_4q_rec_s`.
- `times_ms` and `spread`: per best-of row (`value`, the two kernel
  variants, the 10-qubit bootstrap) its CUDA-event times and
  (max - min) / best.
- `device`: the card's name and power limit as nvidia-smi gives them
  ("cpu" with --device cpu); stderr prints it beside every number.
- `skipped`: {section: repr(error)} of each secondary section that failed
  ({} when none did), so the line itself says what is missing.

Sizes are the module constants (no flags, no environment variables).
Nothing falls back to the CPU: without CUDA the default device refuses.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .tomography.state import make_generator

N_QUBITS = 4
N_SHOTS = 10_000
N_POINTS = 16_384  # bootstrap resamples per timed call
# 60 RrhoR iterations reach the f32 convergence floor on this config
# (max hs distance 3.6e-7 to the 800-iteration fixed point, bench.py)
MLE_ITERS = 60
HEADLINE_REPS = 3  # timed calls after the build-and-first call
VARIANT_REPS = 2  # timed calls of each best-of-2 row
REFERENCE_REC_PER_SEC = 1.0 / 18.0  # BASELINE.md: ~18 s per 4-qubit MLE, CPU
STATE_6Q = (6, 256)  # qubits, resamples of the small kron bootstrap
SCALING_QUBITS = (2, 4, 6, 8, 10, 11)
SIMULATE_ROW_QUBITS = 11  # scaling rows from here on also time both draws
STATE_10Q = (10, 16)  # qubits, resamples of the large kron bootstrap
PROCESS_BOOT = (4, 2_000, 256)  # qubits, shots per POVM, resamples
# FP32 lanes per SM by compute capability (the CUDA programming guide's
# arithmetic-throughput table); no entry, no peak
FP32_LANES_PER_SM = {(9, 0): 128}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def macs_per_resample_iteration(n_qubits: int, n_povms: int, n_outcomes: int) -> int:
    """The RrhoR function's least multiply-adds per resample-iteration:
    two K x D POVM products (p = w2 b, r = w2^T c) and 6 d^3 for R rho R on
    the Hermitian state held as its D real entries (no PTM inside the loop);
    both kernels' shared bound counts the same."""
    d = 2**n_qubits
    return 2 * n_povms * n_outcomes * d * d + 6 * d**3


def flops_per_resample(n_qubits: int, n_povms: int, n_outcomes: int, n_iter: int) -> float:
    """FLOP of one resample's MLE (2 per multiply-add); the simulation, lin
    start and distance are left out, so the share is slightly low."""
    return 2.0 * n_iter * macs_per_resample_iteration(n_qubits, n_povms, n_outcomes)


def fp32_share_pct(flop: float, ms: float, peak_tflops: float) -> float:
    """Per cent of the FP32 peak that `flop` in `ms` milliseconds reach."""
    return 100.0 * flop / (ms * 1e-3) / (peak_tflops * 1e12)


def _nvidia_smi(device: torch.device, query: str) -> str:
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on
    the CPU."""
    if device.type != "cuda":
        return device.type
    return _nvidia_smi(device, "name,power.limit")


def fp32_peak_tflops(device: torch.device) -> float:
    """The card's FP32 peak outside the tensor cores, read at run time:
    SMs x FP32 lanes per SM x 2 x the maximum SM clock (nvidia-smi's
    clocks.max.sm). Raises where any of them cannot be read."""
    if device.type != "cuda":
        raise ValueError(f"{device.type} has no card to read an FP32 peak from")
    props = torch.cuda.get_device_properties(device)
    capability = (props.major, props.minor)
    if capability not in FP32_LANES_PER_SM:
        raise ValueError(f"FP32 lanes per SM of compute capability {capability} not known")
    mhz = float(_nvidia_smi(device, "clocks.max.sm").split()[0])
    return props.multi_processor_count * FP32_LANES_PER_SM[capability] * 2 * mhz * 1e6 / 1e12


def _timed_ms(fn, device: torch.device):
    """(milliseconds, fn()): CUDA events on the card, the host clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def spread(times) -> float:
    """(max - min) / best of a row's times."""
    return (max(times) - min(times)) / min(times)


@contextlib.contextmanager
def flat_kernel_on_main_path():
    """Swap kernels.rhor_mle for kernels.rhor_mle_flat for one block (as
    bench.py swaps the JAX kernels); yields the lane kernel's wrapper."""
    from .ops import kernels

    lane = kernels.rhor_mle
    kernels.rhor_mle = kernels.rhor_mle_flat
    try:
        yield lane
    finally:
        kernels.rhor_mle = lane


def flagship_call(device: torch.device, label: str):
    """The point estimate of the flagship experiment and its bootstrap call:
    returns (run() -> (N_POINTS,) hs distances, one generator across
    calls; the design's (POVMs, outcomes))."""
    from . import GHZ, StateTomograph, if_dst
    from .tomography.bootstrap_core import bootstrap_distances

    state = GHZ(N_QUBITS)
    tmg = StateTomograph(state, key=2026, device=device)
    tmg.experiment(N_SHOTS, "proj-set")
    est = tmg.point_estimate("mle-rhor")
    log(f"point estimate infidelity vs truth: {float(if_dst(est, state)):.2e} on {label}")
    f32 = torch.float32
    bloch = est.bloch_tensor(device, f32)
    povm = torch.as_tensor(tmg.povm_matrix, dtype=f32, device=device)
    n_meas = torch.as_tensor(tmg.n_measurements, dtype=f32, device=device)
    gen = make_generator(0, device)

    def run():
        return bootstrap_distances(gen, bloch, povm, n_meas, n_points=N_POINTS,
                                   method="mle-rhor", dst="hs", max_iter=MLE_ITERS)

    return run, tuple(povm.shape[:2])


def headline(run, device: torch.device, label: str):
    """(times in ms of HEADLINE_REPS calls after one build-and-first call,
    the last call's distances as numpy)."""
    t0 = time.perf_counter()
    run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"build + first call: {time.perf_counter() - t0:.3f} s on {label}")
    times = []
    for _ in range(HEADLINE_REPS):
        ms, d = _timed_ms(run, device)
        times.append(ms)
    d = d.double().cpu().numpy()
    log(f"steady-state times (ms): {[round(t, 3) for t in times]} on {label}")
    log(f"bootstrap distance stats: median={np.median(d):.4f} p95={np.quantile(d, 0.95):.4f} "
        f"(all finite: {bool(np.isfinite(d).all())}) on {label}")
    return times, d


def _povm1(device: torch.device):
    from .measurements import _single_qubit_preset

    return torch.as_tensor(_single_qubit_preset("proj-set"), dtype=torch.float32, device=device)


def state_6q(device: torch.device, label: str) -> dict:
    """Kron-factored linear inversion of one 6-qubit experiment, and the
    6-qubit 'mle' bootstrap from it (one warm call, one timed)."""
    from . import GHZ
    from .tomography import kron_core

    n, n_points = STATE_6Q
    povm1 = _povm1(device)
    b6 = GHZ(n).bloch_tensor(device, torch.float32)
    c6 = kron_core.kron_simulate(make_generator(6, device), povm1, b6, float(N_SHOTS))
    r = kron_core.kron_estimate_lin(c6, povm1, n)
    lin_ms, _ = _timed_ms(lambda: kron_core.kron_estimate_lin(c6, povm1, n), device)
    log(f"secondary: {n}-qubit linear inversion {lin_ms:.3f} ms on {label}")
    gen = make_generator(60, device)

    def run():
        return kron_core.kron_bootstrap_distances(gen, r, povm1, n, float(N_SHOTS),
                                                  n_points=n_points, method="mle", dst="hs",
                                                  max_iter=MLE_ITERS)

    run()
    ms, _ = _timed_ms(run, device)
    rec = n_points / ms * 1e3
    log(f"secondary: {n}-qubit MLE bootstrap {rec:.1f} rec/s ({n_points} resamples, "
        f"{ms:.3f} ms) on {label}")
    return {"state_lin_6q_ms": round(lin_ms, 1), "state_boot_6q_mle_rec_s": round(rec, 1)}


def state_scaling_kron(device: torch.device, label: str) -> dict:
    """One kron-factored lin and MLE-60 reconstruction per qubit count,
    each timed after a warm call, with the MLE's hs distance to the truth."""
    from . import GHZ
    from .tomography import kron_core
    from .tomography.bootstrap_core import _distance_batch

    povm1 = _povm1(device)
    scaling = {}
    for n in SCALING_QUBITS:
        bn = GHZ(n).bloch_tensor(device, torch.float32)
        gen = make_generator(100 + n, device)
        sim_ms, cn = _timed_ms(lambda: kron_core.kron_simulate(gen, povm1, bn, float(N_SHOTS)),
                               device)
        row = {}
        if n >= SIMULATE_ROW_QUBITS:
            del cn
            chunked_ms, cn = _timed_ms(
                lambda: kron_core.kron_simulate_chunked(gen, povm1, bn, float(N_SHOTS)), device)
            row = {"simulate_s": round(sim_ms / 1e3, 4),
                   "simulate_chunked_s": round(chunked_ms / 1e3, 4)}
        kron_core.kron_estimate_lin(cn, povm1, n)
        lin_ms, _ = _timed_ms(lambda: kron_core.kron_estimate_lin(cn, povm1, n), device)
        kron_core.kron_estimate_mle_rhor(cn, povm1, n, max_iter=MLE_ITERS)
        mle_ms, est = _timed_ms(
            lambda: kron_core.kron_estimate_mle_rhor(cn, povm1, n, max_iter=MLE_ITERS), device)
        row["lin_ms"] = round(lin_ms, 2)
        row["mle60_ms"] = round(mle_ms, 2)
        row["mle_hs"] = round(float(_distance_batch("hs", est, bn, n)), 4)
        scaling[str(n)] = row
        del cn
        chunked = (f" (chunked {row['simulate_chunked_s'] * 1e3:.3f} ms)"
                   if "simulate_chunked_s" in row else "")
        log(f"secondary: {n}-qubit simulate {sim_ms:.3f} ms{chunked}, lin {row['lin_ms']} ms, "
            f"MLE-{MLE_ITERS} {row['mle60_ms']} ms, hs-to-truth {row['mle_hs']} on {label}")
    return {"state_scaling_kron": scaling}


def state_boot_10q(device: torch.device, label: str) -> dict:
    """The 10-qubit 'mle' bootstrap, centred on the lin estimate: best of
    VARIANT_REPS calls."""
    from . import GHZ
    from .tomography import kron_core

    n, n_points = STATE_10Q
    povm1 = _povm1(device)
    b10 = GHZ(n).bloch_tensor(device, torch.float32)
    c10 = kron_core.kron_simulate(make_generator(110, device), povm1, b10, float(N_SHOTS))
    r10 = kron_core.kron_estimate_lin(c10, povm1, n)
    del c10
    gen = make_generator(120, device)
    times = []
    for _ in range(VARIANT_REPS):
        ms, d10 = _timed_ms(
            lambda: kron_core.kron_bootstrap_distances(gen, r10, povm1, n, float(N_SHOTS),
                                                       n_points=n_points, method="mle",
                                                       dst="hs", max_iter=MLE_ITERS), device)
        times.append(ms)
    rec = n_points / min(times) * 1e3
    log(f"secondary: {n}-qubit MLE bootstrap {rec:.3f} rec/s ({n_points} resamples, times "
        f"{[round(t, 3) for t in times]} ms, d50={float(d10.median()):.4f}) on {label}")
    key = "state_boot_10q_mle_rec_s"
    return {key: round(rec, 2), "times_ms": {key: times}}


def kernel_variants(run, device: torch.device, label: str) -> dict:
    """The flagship call through the lane kernel and through the flat
    kernel swapped in, best of VARIANT_REPS each, in turns, after one
    build-and-first call of the flat kernel."""
    with flat_kernel_on_main_path():
        run()
    lane, flat = [], []
    for _ in range(VARIANT_REPS):
        lane.append(_timed_ms(run, device)[0])
        with flat_kernel_on_main_path():
            flat.append(_timed_ms(run, device)[0])
    rates = {k: N_POINTS / min(t) * 1e3 for k, t in
             (("kernel_lane_rec_s", lane), ("kernel_flat_rec_s", flat))}
    log(f"secondary: flat-matrix kernel {rates['kernel_flat_rec_s']:.1f} rec/s "
        f"({[round(t, 3) for t in flat]} ms) vs lane {rates['kernel_lane_rec_s']:.1f} "
        f"({[round(t, 3) for t in lane]} ms) on {label}")
    return {**{k: round(v, 1) for k, v in rates.items()},
            "times_ms": {"kernel_lane_rec_s": lane, "kernel_flat_rec_s": flat}}


def process_boot_4q(device: torch.device, label: str) -> dict:
    """The 4-qubit process bootstrap (lifp + CPTP per resample): one warm
    interval, one timed."""
    from . import BootstrapProcessInterval, ProcessTomograph, depolarizing

    n, shots, n_points = PROCESS_BOOT
    ptmg = ProcessTomograph(depolarizing(0.1, n), key=7, device=device)
    ptmg.experiment(shots)
    ptmg.point_estimate("lifp")
    BootstrapProcessInterval(ptmg, n_points=n_points, key=8).setup()
    iv = BootstrapProcessInterval(ptmg, n_points=n_points, key=9)
    ms, _ = _timed_ms(iv.setup, device)
    rec = n_points / ms * 1e3
    log(f"secondary: {n}-qubit process bootstrap {rec:.2f} rec/s ({n_points} resamples, "
        f"{ms:.3f} ms) on {label}")
    return {"process_boot_4q_rec_s": round(rec, 1)}


def _record_times(extras: dict, key: str, times) -> None:
    extras["times_ms"][key] = [round(t, 3) for t in times]
    extras["spread"][key] = round(spread(times), 4)


def _section(extras: dict, name: str, fn) -> None:
    """Merge fn()'s keys into `extras` (its `times_ms` rows with their
    spread); on failure record repr(error) under skipped[name]."""
    try:
        out = fn()
    except Exception as e:  # a failed secondary never costs the headline
        log(f"secondary {name} skipped: {e!r}")
        extras["skipped"][name] = repr(e)
        return
    for key, times in out.pop("times_ms", {}).items():
        _record_times(extras, key, times)
    extras.update(out)


def run(device: torch.device) -> dict:
    """Every section on `device`; returns the JSON line's object."""
    extras = {"skipped": {}, "times_ms": {}, "spread": {}, "device": None}
    _section(extras, "device", lambda: {"device": device_label(device)})
    label = extras["device"] or device.type
    call, (n_povms, n_outcomes) = flagship_call(device, label)
    times, _ = headline(call, device, label)
    best = min(times)
    value = N_POINTS / best * 1e3
    flop = flops_per_resample(N_QUBITS, n_povms, n_outcomes, MLE_ITERS) * N_POINTS
    tflops = flop / (best * 1e-3) / 1e12
    log(f"work: {flop / N_POINTS / 1e6:.2f} MFLOP/resample x {value:.0f}/s = {tflops:.3f} "
        f"TFLOP/s on {label}")
    _record_times(extras, "value", times)
    extras.update(tflops=round(tflops, 2), mle_iters=MLE_ITERS, n_points=N_POINTS)

    def share():
        peak = fp32_peak_tflops(device)
        pct = fp32_share_pct(flop, best, peak)
        log(f"mfu: {pct:.2f}% of the {peak:.2f} TFLOP/s FP32 peak on {label}")
        return {"mfu_f32_pct": round(pct, 1)}

    _section(extras, "mfu_f32_pct", share)
    _section(extras, "state_6q", lambda: state_6q(device, label))
    _section(extras, "state_scaling_kron", lambda: state_scaling_kron(device, label))
    _section(extras, "state_boot_10q", lambda: state_boot_10q(device, label))
    _section(extras, "kernel_variants", lambda: kernel_variants(call, device, label))
    _section(extras, "process_boot_4q", lambda: process_boot_4q(device, label))
    return {
        "metric": f"bootstrapped {N_QUBITS}-qubit MLE reconstructions/sec (proj-set, "
                  f"{N_SHOTS // 1000}k shots/POVM, RrhoR-{MLE_ITERS})",
        "value": round(value, 1),
        "unit": "reconstructions/sec",
        "vs_baseline": round(value / REFERENCE_REC_PER_SEC, 1),
        "extras": extras,
    }


def main(argv=None) -> dict:
    """Run the benchmark, print its JSON line as the last line of stdout
    and return it."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the benchmark runs on (default cuda)")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; pass --device cpu to run on the CPU")
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        result = run(device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
