"""Fidelity confidence bands vs confidence level (epsilon sweep).

Port of examples/fidelity_intervals.py, the counterpart of the reference's
notebooks/Fidelity.ipynb: sweep
epsilon = 1 - confidence over a log grid and trace the min/max fidelity
band of a MomentFidelity interval around a depolarized GHZ state (QST)
and a depolarized identity channel (QPT), at several shot counts.

The reference loops 100 repetitions x 3 shot counts sequentially and
pickles the curves for plotting; here each repetition's band comes from
the closed-form sliced-ball fidelity solver (convex/ball.py — the
reference solves 2 cvxopt SOCPs per grid point, interval.py:134-158),
so the whole sweep takes seconds and we print summary statistics
directly.

Run:  python -m quantpy_tpu_torch.examples.fidelity_intervals [--repeats N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.channel import depolarize, depolarizing
from quantpy_tpu_torch.examples import _viz, parse_args


def state_fidelity_sweep(epsilons: np.ndarray, n_shots: int, repeats: int, key0: int):
    """Min/max fidelity bands for a depolarized 2-qubit GHZ state."""
    target = qt.GHZ(2)
    state = depolarizing(0.1, n_qubits=2).transform(target)
    true_fid = float(np.dot(target.bloch, state.bloch)) * 2**2
    conf_levels = 1 - epsilons
    bands = []
    for r in range(repeats):
        tmg = qt.StateTomograph(state, key=key0 + r)
        tmg.experiment(n_shots, "proj-set")
        tmg.point_estimate("mle-rhor")
        interval = qt.MomentFidelityStateInterval(tmg, target_state=target)
        (fmin, fmax), _ = interval(conf_levels)
        bands.append((np.clip(fmin, 0, 1), np.clip(fmax, 0, 1)))
    return true_fid, bands


def process_fidelity_sweep(epsilons: np.ndarray, n_shots: int, repeats: int, key0: int):
    """Min/max fidelity bands for a depolarized 1-qubit identity channel."""
    from quantpy_tpu_torch.operator import Id

    target = Id.as_channel()
    channel = depolarize(target, 0.1)
    true_fid = float(np.dot(target.choi.bloch, channel.choi.bloch))
    conf_levels = 1 - epsilons
    bands = []
    for r in range(repeats):
        tmg = qt.ProcessTomograph(channel, key=key0 + r)
        tmg.experiment(n_shots, "proj-set")
        tmg.point_estimate("lifp")
        interval = qt.MomentFidelityProcessInterval(tmg, target_process=target)
        (fmin, fmax), _ = interval(conf_levels)
        bands.append((np.clip(fmin, 0, 1), np.clip(fmax, 0, 1)))
    return true_fid, bands


def report(kind: str, true_fid: float, bands, epsilons: np.ndarray, n_shots: int):
    fmin = np.stack([b[0] for b in bands])
    fmax = np.stack([b[1] for b in bands])
    cover = float(np.mean((fmin <= true_fid) & (true_fid <= fmax)))
    # band width at the tightest / loosest ends of the sweep
    w_lo = float(np.mean(fmax[:, 0] - fmin[:, 0]))
    w_hi = float(np.mean(fmax[:, -1] - fmin[:, -1]))
    print(
        f"{kind:>8} | {n_shots:>6} shots | true F = {true_fid:.4f} | "
        f"covered {cover:5.1%} | width {w_hi:.4f} @eps={epsilons[-1]:.2g} "
        f"-> {w_lo:.4f} @eps={epsilons[0]:.2g}"
    )


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=20)
    args = parse_args(parser, args)

    epsilons = np.logspace(-5, -0.01, 50)
    print("fidelity bands (MomentFidelity intervals, closed-form ball solver)")
    qst_sweeps = []
    for n_shots in (1_000, 10_000, 100_000):
        true_fid, bands = state_fidelity_sweep(epsilons, n_shots, args.repeats, 100)
        report("QST", true_fid, bands, epsilons, n_shots)
        qst_sweeps.append((n_shots, true_fid, bands))
    for n_shots in (1_000, 10_000, 100_000):
        true_fid, bands = process_fidelity_sweep(epsilons, n_shots, args.repeats, 500)
        report("QPT", true_fid, bands, epsilons, n_shots)

    if _viz.figures_enabled() and qst_sweeps:
        fig, ax = _viz.new_axes(
            "QST fidelity bands vs error budget "
            "(depolarized 2-qubit GHZ, mean over repeats)",
            "epsilon = 1 - confidence",
            "fidelity bound",
        )
        true_fid = qst_sweeps[0][1]
        for (n_shots, _, bands), color in zip(qst_sweeps, _viz.PALETTE):
            fmin = np.stack([b[0] for b in bands]).mean(0)
            fmax = np.stack([b[1] for b in bands]).mean(0)
            ax.semilogx(
                epsilons, fmin, color=color, linewidth=2,
                label=f"{n_shots:,} shots", zorder=3,
            )
            ax.semilogx(epsilons, fmax, color=color, linewidth=2, zorder=3)
            ax.fill_between(
                epsilons, fmin, fmax, color=color, alpha=0.12, linewidth=0,
            )
        ax.axhline(
            true_fid, color=_viz.TEXT2, linewidth=1.2, linestyle="--",
            zorder=2,
        )
        ax.annotate(
            "true fidelity", (epsilons[1], true_fid),
            textcoords="offset points", xytext=(0, 5),
            color=_viz.TEXT2, fontsize=8,
        )
        _viz.legend(ax)
        _viz.save(fig, "fidelity_bands")


if __name__ == "__main__":
    main()
