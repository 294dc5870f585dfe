"""Confidence-polytope coverage curves (arXiv:2109.04734 reproduction).

Port of examples/polytope_verification.py, the counterpart of the
reference's polytopes/notebooks/Verification.ipynb
(fig1a-d data): empirical coverage of the polytope CI for GHZ states and
depolarizing channels across confidence levels. The reference loops 10^4
Python trials; here each curve is a handful of batched device calls.

Run:  python -m quantpy_tpu_torch.examples.polytope_verification [--trials 2000] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.channel import depolarizing
from quantpy_tpu_torch.examples import _viz, parse_args
from quantpy_tpu_torch.tomography.polytopes.verification import test_qpt, test_qst


def main(n_trials: int) -> None:
    conf_levels = np.linspace(0.1, 0.95, 8)
    print(f"nominal levels: {np.round(conf_levels, 2)}")
    curves = []
    for n in [1, 2, 3]:
        cov = test_qst(
            qt.GHZ(n), conf_levels, n_measurements=1000, n_trials=n_trials
        )
        print(f"QST GHZ-{n} coverage: {np.round(cov, 3)}")
        curves.append((f"QST GHZ-{n}", cov))
    for p in [0.2, 0.8]:
        cov = test_qpt(
            depolarizing(p), conf_levels, n_measurements=1000,
            n_trials=max(n_trials // 4, 100), input_states="sic",
        )
        print(f"QPT depolarizing({p}) coverage: {np.round(cov, 3)}")
        curves.append((f"QPT depol({p})", cov))

    if _viz.figures_enabled():
        fig, ax = _viz.new_axes(
            "Confidence-polytope coverage vs nominal level "
            "(arXiv:2109.04734 reproduction)",
            "nominal confidence level",
            "empirical coverage",
        )
        ax.plot([0, 1], [0, 1], color=_viz.GRID, linewidth=1.2, zorder=1)
        for (label, cov), color in zip(curves, _viz.PALETTE):
            ax.plot(
                conf_levels, cov, color=color, linewidth=2, marker="o",
                markersize=4, label=label, zorder=3,
            )
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1.02)
        _viz.legend(ax)
        _viz.save(fig, "polytope_coverage")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=2000)
    args = parse_args(parser)
    main(args.trials)
