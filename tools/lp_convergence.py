#!/usr/bin/env python3
"""Follow chip_smoke.py's full-width polytope LPs past their iteration cap.

    python3 tools/lp_convergence.py [--rows kron process] [--cap 60000]
                                    [--every 5000] [--device cuda]

Builds the tomograph of each phase-9 row as chip_smoke.py does (GHZ-6 in
kron mode; depolarizing(0.1, 4) with 256 proj4 inputs), sets up its
PolytopeStateInterval / PolytopeProcessInterval with the LP's cap raised to
--cap, and prints, every --every iterations of each direction (min, max),
the batch-maximum relative residuals that the stopping rule reads (primal,
dual, gap, against the float32 tol) and how many margins still violate a
constraint by more than 1e-3, the violation over which a margin reports
the bound 1.0. At the end it prints the bounds at cl 0.5, 0.9 and 0.99 and
the time. A cap that is a multiple of 20,000 passes the smoke's cap on the
way, so one run reads both.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def _follow(every: int):
    """Patch convex/lp.py's PDHG loop so that it prints its residual
    readings every `every` iterations; returns the undo function."""
    from quantpy_tpu_torch.convex import lp

    pdhg, residuals = lp._pdhg, lp._residuals
    state = {"solve": 0, "chunks": 0}

    def printing_residuals(fwd, adj, c, b, x, y):
        out = residuals(fwd, adj, c, b, x, y)
        state["chunks"] += 1
        iters = state["chunks"] * lp._CHUNK
        if iters % every == 0:
            res_p, res_d, gap, scale = out[2].tolist()
            b_scale = 1.0 + float(b.abs().amax())
            c_scale = 1.0 + float(c.abs().amax())
            flagged = int((out[1] > 1e-3).sum())
            print(f"      {'min' if state['solve'] % 2 == 0 else 'max'} LP, {iters} iterations: "
                  f"primal {res_p / b_scale:.3e}, dual {res_d / c_scale:.3e}, gap "
                  f"{gap / scale:.3e} relative; {flagged} of {out[1].numel()} margins with a "
                  "violation over 1e-3", flush=True)
        return out

    def counting_pdhg(*args):
        state["chunks"] = 0
        try:
            return pdhg(*args)
        finally:
            state["solve"] += 1

    lp._pdhg, lp._residuals = counting_pdhg, printing_residuals

    def undo():
        lp._pdhg, lp._residuals = pdhg, residuals

    return undo


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", nargs="+", default=["kron", "process"],
                        choices=["kron", "process"])
    parser.add_argument("--cap", type=int, default=60_000)
    parser.add_argument("--every", type=int, default=5_000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    import numpy as np

    import chip_smoke
    import quantpy_tpu_torch as qtt
    from quantpy_tpu_torch import config

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lp_convergence: no CUDA device")
    config.set_device(args.device)
    if args.device == "cuda":
        print(chip_smoke.phase0_device(), flush=True)
    undo = _follow(args.every)
    try:
        for row in args.rows:
            if row == "kron":
                n, shots, n_points = chip_smoke.ANALYTIC_KRON
                tmg = qtt.StateTomograph(qtt.GHZ(n), key=96)  # chip_smoke.py's seed
                tmg.experiment(shots, "proj-set")
                iv = qtt.PolytopeStateInterval(tmg, n_points=n_points)
                what = f"GHZ({n}) kron, {n_points} margins"
            else:
                n, shots, n_points = chip_smoke.ANALYTIC_CHANNEL
                tmg = qtt.ProcessTomograph(qtt.depolarizing(0.1, n), key=97)
                tmg.experiment(shots)
                iv = qtt.PolytopeProcessInterval(tmg, n_points=n_points)
                what = f"depolarizing(0.1, {n}) two-factor, {n_points} margins"
            iv.LP_ITERS = args.cap
            print(f"    {what}, float32, cap {args.cap}:", flush=True)
            t0 = time.perf_counter()
            iv.setup()
            seconds = time.perf_counter() - t0
            (lo, hi), _ = iv(np.asarray(chip_smoke.ANALYTIC_LEVELS))
            bounds = [(round(float(a), 6), round(float(b), 6)) for a, b in zip(lo, hi)]
            print(f"    {what}: lp_iterations {iv.lp_iterations} in {seconds:.3f} s; bounds "
                  f"{bounds} at cl {chip_smoke.ANALYTIC_LEVELS}", flush=True)
    finally:
        undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
