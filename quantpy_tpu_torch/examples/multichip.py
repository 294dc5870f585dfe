"""Multi-device scaling over a single-controller device mesh (port of
examples/multichip.py).

The reference (nordmtr/quantpy) is single-process NumPy with sequential
loops. Two sharding modes:

1. RESAMPLE sharding: thousands of independent simulate+estimate problems
   are split over the mesh's shards; each shard runs the single-device
   bootstrap and the distances are gathered (`sharded_bootstrap_distances`).
2. OPERATOR sharding: for 11+ qubits, where the 6^n outcome tensor is
   8.7 GB at 12 qubits, the first measurement group's outcome axis is split
   over the shards, counts are BORN split (`sharded_kron_simulate`), linear
   inversion sums only the (4^n,) right-hand sides, and the RrhoR MLE
   iteration runs on the split design with one sum of (4^n,) vectors and one
   concatenation of row blocks per iteration
   (`sharded_kron_estimate_mle_rhor`).

The mesh is chosen before any CUDA work begins: every card of the host
when there are two or more, else LOGICAL_SHARDS shards on the one card
(said so in the output); with --device cpu, CPU_SHARDS shards on the CPU.
No run falls back from the card to the CPU.

Run:  python -m quantpy_tpu_torch.examples.multichip [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from quantpy_tpu_torch.examples import parse_args

#: shards of the mesh on a host with one card, and on the CPU (the JAX
#: tests' 8 virtual devices)
LOGICAL_SHARDS = 4
CPU_SHARDS = 8


def _mesh_devices(device: torch.device):
    """(devices of the mesh, a line saying what they are)."""
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            return [torch.device("cuda", i) for i in range(n_cards)], f"{n_cards} cards"
        return [torch.device("cuda", 0)] * LOGICAL_SHARDS, (
            f"one card: {LOGICAL_SHARDS} logical shards on cuda:0 (no multi-device speed-up)"
        )
    return [device] * CPU_SHARDS, f"{CPU_SHARDS} shards on {device.type}"


def main(args=None) -> None:
    parsed = parse_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]), args)
    devices, what = _mesh_devices(torch.device(parsed.device))

    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch.measurements import _single_qubit_preset
    from quantpy_tpu_torch.parallel import (
        make_mesh,
        sharded_bootstrap_distances,
        sharded_kron_estimate_lin,
        sharded_kron_estimate_mle_rhor,
        sharded_kron_simulate,
    )
    from quantpy_tpu_torch.tomography import kron_core
    from quantpy_tpu_torch.tomography.bootstrap_core import _distance_batch

    mesh = make_mesh(devices=devices)
    print(f"mesh: {mesh.size} shards, {what}")

    # --- 1. resample-sharded bootstrap (2 qubits, MLE re-estimates) ---
    tmg = qtt.StateTomograph(qtt.GHZ(2), key=11)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lin")
    n_boot = 16 * mesh.size
    d = sharded_bootstrap_distances(
        mesh,
        0,
        torch.as_tensor(est.bloch, dtype=torch.float32, device=mesh.devices[0]),
        tmg.povm_matrix,
        tmg.n_measurements,
        n_points=n_boot,
        method="mle-rhor",
        max_iter=40,
    ).cpu().numpy()
    print(
        f"resample-sharded bootstrap: {n_boot} resamples over {mesh.size} "
        f"shards, d50={np.median(d):.4f} d90={np.quantile(d, 0.9):.4f}"
    )

    # --- 2. operator-sharded pipeline (6 qubits here; same code at 12) ---
    n = 6
    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=torch.float32)
    truth = torch.as_tensor(qtt.GHZ(n).bloch, dtype=torch.float32, device=mesh.devices[0])
    counts = sharded_kron_simulate(mesh, 1, povm1, truth, 2000.0)
    print(
        f"operator-sharded simulate: counts {tuple(counts.shape)} born split in "
        f"{len(counts.shards)} shards of {tuple(counts.shards[0].shape)}"
    )
    lin = sharded_kron_estimate_lin(mesh, counts, povm1, n)
    mle = sharded_kron_estimate_mle_rhor(mesh, counts, povm1, n, init_bloch=lin, max_iter=40)
    d_lin = float(_distance_batch("hs", lin, truth, n))
    d_mle = float(_distance_batch("hs", mle, truth, n))
    # single-device twin on the same (gathered) counts: identical math
    gathered = counts.gather()
    mle_1 = kron_core.kron_estimate_mle_rhor(gathered, povm1.to(gathered.device), n, max_iter=40)
    gap = float((mle_1 - mle).abs().max())
    print(
        f"operator-sharded {n}q: lin hs-to-truth {d_lin:.4f}, MLE-40 "
        f"{d_mle:.4f}; sharded-vs-single MLE max|diff| {gap:.2e}"
    )
    print("(the same sharded pipeline carries 12 qubits: 8.7 GB of counts in float32)")


if __name__ == "__main__":
    main()
