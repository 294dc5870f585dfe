"""Quantum process tomography walkthrough.

Port of examples/process_tomography.py, the counterpart of the
reference's examples/process_tomography.ipynb: simulate
QPT of standard channels, reconstruct with every method, inspect Choi/Kraus
representations and CPTP projection behavior.

Run:  python -m quantpy_tpu_torch.examples.process_tomography [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.channel import amplitude_damping, dephasing, depolarizing
from quantpy_tpu_torch.examples import parse_args
from quantpy_tpu_torch.operator import H


def main(args=None) -> None:
    parse_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]), args)
    channels = {
        "depolarizing(0.3)": depolarizing(0.3),
        "dephasing(0.5)": dephasing(0.5),
        "amplitude_damping(0.25)": amplitude_damping(0.25),
        "Hadamard (unitary)": H.as_channel(),
    }
    print(f"{'channel':>24} | {'method':>7} | {'hs(choi)':>9} | {'cptp':>5}")
    for name, ch in channels.items():
        tmg = qt.ProcessTomograph(ch, key=7)
        tmg.experiment(20_000, "proj-set")
        for method in ["lifp", "pgdb", "states"]:
            est = tmg.point_estimate(method)
            d = float(qt.hs_dst(est.choi, ch.choi))
            print(f"{name:>24} | {method:>7} | {d:>9.4f} | {est.is_cptp(verbose=False)!s:>5}")

    # Kraus extraction from a reconstructed channel
    tmg = qt.ProcessTomograph(amplitude_damping(0.25), key=8)
    tmg.experiment(50_000, "proj-set")
    est = tmg.point_estimate("lifp")
    print("\nKraus operators of reconstructed amplitude damping:")
    for k in est.kraus:
        print(np.round(k.matrix, 3))
    completeness = sum(k.matrix.conj().T @ k.matrix for k in est.kraus)
    print("sum K^H K =\n", np.round(completeness, 4))


if __name__ == "__main__":
    main()
