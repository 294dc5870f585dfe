"""The least work of the kron-factored RrhoR loop, counted from the
problem and not from the program's grouping of the qubits, against the
peaks of `benchmark/roofline.py`.

Per resample-iteration, with c = m1 p1 the outcomes of one qubit's
settings (6 for proj-set) and d = 2^n: the forward map applied one qubit
at a time, 8 sum_{k=1..n} c^k 4^(n-k) FLOP (the k-th step makes c^k
4^(n-k) entries, each a sum of 4 products); the adjoint, 2c sum_{k=1..n}
c^(n-k) 4^k (each entry a sum of c products); and R rho R, 12 d^3, as the
RrhoR kernel's bound counts it (6 d^3 multiply-adds on the Hermitian
state). The bytes: each resample's frequencies and start read once and its
estimate written once, in float32.
"""

from __future__ import annotations

from benchmark.roofline import F32_BYTES


def flops_per_resample_iteration(n_qubits: int, outcomes_per_qubit: int) -> int:
    n, c = n_qubits, outcomes_per_qubit
    forward = 8 * sum(c**k * 4 ** (n - k) for k in range(1, n + 1))
    adjoint = 2 * c * sum(c ** (n - k) * 4**k for k in range(1, n + 1))
    return forward + adjoint + 12 * (2**n) ** 3


def rhor_bytes(n_qubits: int, outcomes_per_qubit: int, resamples: int) -> int:
    """Bytes of the frequencies (c^n each) and the starts (4^n) read once and
    the estimates (4^n) written once, in float32."""
    return F32_BYTES * resamples * (outcomes_per_qubit**n_qubits + 2 * 4**n_qubits)


def outcomes_per_qubit(config: dict) -> int:
    """c = m1 p1 of a product design from the configuration's settings and
    outcomes: m1^n = n_povms and p1^n = n_outcomes."""
    n = config["n_qubits"]
    m1 = round(config["n_povms"] ** (1 / n))
    p1 = round(config["n_outcomes"] ** (1 / n))
    if m1**n != config["n_povms"] or p1**n != config["n_outcomes"]:
        raise ValueError("the configuration's design is not a product of single-qubit blocks")
    return m1 * p1
