"""Qubit-count scaling study: factored vs dense measurement paths.

Port of examples/scaling_study.py. The reference's dense linear inversion
hits ~45 s at 6 qubits on a CPU (BASELINE.md); the kron-factored paths
(tomography/kron_core.py) never materialize anything larger than the
outcome counts. Times are the device's, printed with its name.

Run:  python -m quantpy_tpu_torch.examples.scaling_study [--max-qubits 10] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import quantpy_tpu_torch as qt
from quantpy_tpu_torch import config
from quantpy_tpu_torch.examples import _viz, device_label, parse_args
from quantpy_tpu_torch.measurements import _single_qubit_preset
from quantpy_tpu_torch.tomography import kron_core
from quantpy_tpu_torch.utils import StageTimer


def main(max_qubits: int) -> None:
    device, dtype = config.get_device(), config.rdtype()
    povm1 = torch.as_tensor(_single_qubit_preset("proj-set"), dtype=dtype, device=device)
    rows = []
    print(f"times on {device_label()}")
    print(f"{'n':>2} | {'counts shape':>14} | {'simulate':>9} | {'lin':>9} | "
          f"{'mle-60':>9} | {'mle hs-to-truth':>15}")
    for n in range(2, max_qubits + 1):
        state = qt.GHZ(n)
        bloch = state.bloch_tensor(device, dtype)
        timer = StageTimer()

        def timed(name, fn):
            fn()  # warm up, then time
            with timer.stage(name):
                out = fn()
            return out, timer.stages[name]

        gen = torch.Generator(device=device)
        gen.manual_seed(n)
        counts, t_sim = timed("simulate", lambda: kron_core.kron_simulate(gen, povm1, bloch, 10_000.0))
        _, t_lin = timed("lin", lambda: kron_core.kron_estimate_lin(counts, povm1, n))
        est, t_mle = timed(
            "mle", lambda: kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=60)
        )
        d = float(qt.hs_dst(qt.Qobj(est.cpu().numpy().astype(np.float64)), state))
        print(f"{n:>2} | {str(tuple(counts.shape)):>14} | {t_sim*1e3:>7.1f}ms | "
              f"{t_lin*1e3:>7.1f}ms | {t_mle*1e3:>7.1f}ms | {d:>15.4f}")
        rows.append((n, t_sim, t_lin, t_mle))

    if _viz.figures_enabled() and rows:
        fig, ax = _viz.new_axes(
            f"Kron-factored tomography scaling (10k shots, proj-set, {device_label()})",
            "qubits",
            "wall time per call (s)",
        )
        ns = [r[0] for r in rows]
        for idx, (label, col) in enumerate(
            [("simulate", 1), ("linear inversion", 2), ("MLE (60 iters)", 3)]
        ):
            ax.semilogy(
                ns, [r[col] for r in rows], color=_viz.PALETTE[idx],
                linewidth=2, marker="o", markersize=4, label=label, zorder=3,
            )
        # reference comparison points (BASELINE.md, dense single-core CPU)
        ax.semilogy(
            [5, 6], [0.65, 45.0], color=_viz.TEXT2, linewidth=0,
            marker="x", markersize=7, label="reference lin (BASELINE.md)",
            zorder=3,
        )
        ax.set_xticks(ns)
        _viz.legend(ax)
        _viz.save(fig, "scaling_study")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--max-qubits", type=int, default=10)
    args = parse_args(parser)
    main(args.max_qubits)
