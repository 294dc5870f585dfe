"""Confidence-interval family tour + calibration curves.

Port of examples/confidence_intervals.py, the counterpart of the
reference's notebooks/Intervals.ipynb and
examples/confidence_intervals.ipynb: build every interval family on one
experiment, compare their radii, and compute a calibration curve with the
metrics harness.

Run:  python -m quantpy_tpu_torch.examples.confidence_intervals [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.examples import _viz, parse_args
from quantpy_tpu_torch.metrics import get_CL_list_state


def main(args=None) -> None:
    parse_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]), args)
    tmg = qt.StateTomograph(qt.GHZ(2), key=11)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("mle-rhor")

    conf_levels = np.array([0.5, 0.9, 0.99])
    intervals = {
        "moment (gamma)": qt.MomentInterval(tmg),
        "sugiyama": qt.SugiyamaInterval(tmg),
        "bootstrap-lin": qt.BootstrapStateInterval(tmg, n_points=512),
        "bootstrap-mle": qt.BootstrapStateInterval(
            tmg, n_points=512, method="mle-rhor"
        ),
        "mhmc": qt.MHMCStateInterval(
            tmg, n_points=500, burn_steps=500, use_new_estimate=True
        ),
    }
    print(f"{'interval':>14} | " + " | ".join(f"d@{c}" for c in conf_levels))
    grid = np.linspace(0.02, 0.98, 49)
    radius_curves = []
    for name, iv in intervals.items():
        d, _ = iv(conf_levels)
        print(f"{name:>14} | " + " | ".join(f"{x:.4f}" for x in np.asarray(d)))
        radius_curves.append((name, np.asarray(iv(grid)[0])))

    # fidelity band w.r.t. the true state
    fiv = qt.MomentFidelityStateInterval(tmg, target_state=tmg.state)
    (fmin, fmax), _ = fiv(conf_levels)
    print("\nfidelity band vs truth:")
    for c, lo, hi in zip(conf_levels, fmin, fmax):
        print(f"  {c:.2f}: [{lo:.4f}, {hi:.4f}]")

    # calibration: achieved confidence levels should be ~uniform
    levels = get_CL_list_state(
        qt.GHZ(1), interval="moment", n_measurements=1000, n_iter=40
    )
    quantiles = np.linspace(0, 1, len(levels))
    err = float(np.max(np.abs(levels - quantiles)))
    print(f"\nmoment-interval calibration: max |achieved - uniform| = {err:.3f}")

    if _viz.figures_enabled():
        fig, ax = _viz.new_axes(
            "Interval families on one 2-qubit GHZ experiment (3000 shots)",
            "confidence level",
            "HS-distance radius",
        )
        for (name, d), color in zip(radius_curves, _viz.PALETTE):
            ax.plot(grid, d, color=color, linewidth=2, label=name, zorder=3)
        ax.set_xlim(0, 1)
        _viz.legend(ax)
        _viz.save(fig, "interval_families")

        fig, ax = _viz.new_axes(
            "Moment-interval calibration (1-qubit GHZ, 1000 shots)",
            "uniform quantile",
            "achieved confidence level",
        )
        ax.plot([0, 1], [0, 1], color=_viz.GRID, linewidth=1.2, zorder=1)
        ax.plot(
            quantiles, levels, color=_viz.PALETTE[0], linewidth=2,
            marker="o", markersize=3, zorder=3,
        )
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1.02)
        _viz.save(fig, "calibration")


if __name__ == "__main__":
    main()
