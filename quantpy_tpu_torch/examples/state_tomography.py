"""Estimator-quality and timing study for quantum state tomography.

Port of examples/state_tomography.py, the counterpart of the reference's
examples/state_tomography.ipynb (estimator convergence vs shot count, cells
3-10, and the "time test", cells 12-16). Where the reference reconstructs
one experiment at a time, every point here is a *batch* of experiments
reconstructed in one device call. Times are the device's, printed with its
name.

Run:  python -m quantpy_tpu_torch.examples.state_tomography [--repeats 50] [--qubits 2] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.examples import _viz, device_label, parse_args
from quantpy_tpu_torch.tomography.bootstrap_core import _distance_batch
from quantpy_tpu_torch.utils import StageTimer


def quality_study(n_qubits: int, repeats: int) -> None:
    """HS distance of lin/mle estimates vs shot count, `repeats` experiments
    per point: the convergence plot data of the reference's cell 3."""
    state = qt.GHZ(n_qubits)
    tmg = qt.StateTomograph(state, key=1)
    print(f"\n=== estimator quality: {n_qubits}-qubit GHZ, {repeats} repeats ===")
    print(f"{'shots':>9} | {'lin median hs':>14} | {'mle-rhor median hs':>18}")
    shot_list = [100, 1_000, 10_000, 100_000]
    medians = {"lin": [], "mle-rhor": []}
    for shots in shot_list:
        tmg.experiment(shots, "proj-set")
        counts = tmg.simulate_batch(repeats)
        row = []
        for method in ["lin", "mle-rhor"]:
            blochs = tmg.estimate_batch(counts, method)
            d = _distance_batch(
                "hs", blochs, state.bloch_tensor(blochs.device, blochs.dtype), n_qubits
            )
            row.append(float(np.median(d.cpu().numpy())))
            medians[method].append(row[-1])
        print(f"{shots:>9} | {row[0]:>14.5f} | {row[1]:>18.5f}")

    if _viz.figures_enabled():
        fig, ax = _viz.new_axes(
            f"Estimator convergence: {n_qubits}-qubit GHZ, "
            f"median over {repeats} experiments",
            "shots per POVM",
            "median HS distance to truth",
        )
        for idx, (method, label) in enumerate(
            [("lin", "linear inversion"), ("mle-rhor", "MLE (RrhoR)")]
        ):
            ax.loglog(
                shot_list, medians[method], color=_viz.PALETTE[idx],
                linewidth=2, marker="o", markersize=4, label=label, zorder=3,
            )
        _viz.legend(ax)
        _viz.save(fig, "estimator_quality")


def time_study(max_qubits: int) -> None:
    """Wall-clock per reconstruction vs qubit count (reference cells 12-16,
    examples/pictures/time_test.png), at batch sizes 1 and 256."""
    print(f"\n=== time per reconstruction (10k shots, proj-set) on {device_label()} ===")
    print(f"{'n':>2} | {'method':>8} | {'batch':>5} | {'sec/reconstruction':>18}")
    timer = StageTimer()
    for n in range(1, max_qubits + 1):
        state = qt.GHZ(n)
        tmg = qt.StateTomograph(state, key=2)
        tmg.experiment(10_000, "proj-set")
        for method in ["lin", "mle-rhor"]:
            for batch in [1, 256]:
                counts = tmg.simulate_batch(batch)
                tmg.estimate_batch(counts, method)  # warm up, then time
                name = f"{n}-{method}-{batch}"
                with timer.stage(name):
                    tmg.estimate_batch(counts, method)
                dt = timer.stages[name] / batch
                print(f"{n:>2} | {method:>8} | {batch:>5} | {dt:>18.6f}")


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=50)
    parser.add_argument("--qubits", type=int, default=2)
    parser.add_argument("--max-qubits", type=int, default=4)
    parsed = parse_args(parser, args)
    print("device:", device_label())
    quality_study(parsed.qubits, parsed.repeats)
    time_study(parsed.max_qubits)


if __name__ == "__main__":
    main()
