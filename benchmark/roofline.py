"""The yardstick's arithmetic: work counted from the problem's shapes, the
card's published peaks, and the card's label.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (FP32
outside the tensor cores, HBM3 bandwidth); a card set below 700 W runs
slower, so every reading prints the card's power limit beside it.
"""

from __future__ import annotations

import subprocess

FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32_BYTES = 4


# Frozen copy of quantpy_tpu_torch/bench.py::macs_per_resample_iteration.
def macs_per_resample_iteration(n_qubits: int, n_povms: int, n_outcomes: int) -> int:
    """The RrhoR function's least multiply-adds per resample-iteration:
    two K x D POVM products (p = w2 b, r = w2^T c) and 6 d^3 for R rho R on
    the Hermitian state held as its D real entries (no PTM inside the loop);
    both kernels' shared bound counts the same."""
    d = 2**n_qubits
    return 2 * n_povms * n_outcomes * d * d + 6 * d**3


# Frozen copy of quantpy_tpu_torch/bench.py::flops_per_resample.
def flops_per_resample(n_qubits: int, n_povms: int, n_outcomes: int, n_iter: int) -> float:
    """FLOP of one resample's MLE (2 per multiply-add); the simulation, lin
    start and distance are left out, so the share is slightly low."""
    return 2.0 * n_iter * macs_per_resample_iteration(n_qubits, n_povms, n_outcomes)


def rhor_bytes(n_qubits: int, n_povms: int, n_outcomes: int, n_points: int, n_designs: int = 1) -> int:
    """Bytes RrhoR must move in float32: the frequencies (B x K) and the
    starts (B x D) read once, the design (K x D) read once per card that
    holds it, the estimates (B x D) written once."""
    k, d2 = n_povms * n_outcomes, 4**n_qubits
    return F32_BYTES * (n_points * k + 2 * n_points * d2 + n_designs * k * d2)


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time the card could take: compute or memory, whichever binds."""
    return max(flop / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


# Frozen copy of quantpy_tpu_torch/bench.py::device_label (and its _nvidia_smi).
def device_label(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()
