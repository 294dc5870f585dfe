"""Teleportation QPT from real IBMQ counts with a readout-calibrated POVM.

Port of examples/teleportation.py. Certify a teleportation circuit run on
IBMQ hardware as a quantum process. The ideal teleportation channel is the
identity; the experiment teleports four tetrahedral input states (|0> and
three Ry/Rz rotations of it, an exact 1-qubit operator basis) and measures
each output in three bases (RY- and RX-rotated plus computational), with
the detector response calibrated into the POVM: P(read 0 | state 0) =
0.972, P(read 0 | state 1) = 0.093 instead of the ideal projector. The
measurement matrix rows are the *calibrated* effects, so readout error is
corrected by the reconstruction itself.

The measured counts below are the published IBMQ records of the
reference's notebooks/Teleportation.ipynb (cell 5). The workflow (custom
input-state basis, custom full-system POVM matrix, dummy experiment to fix
the design, `results` overwrite, fidelity bands) is the notebook's.

Run:  python -m quantpy_tpu_torch.examples.teleportation [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.examples import parse_args
from quantpy_tpu_torch.operator import Id, RX, RY, RZ

# IBMQ teleportation records: 4 input states x 3 measurement bases x 2
# outcomes, 8192 shots each (notebooks/Teleportation.ipynb cell 5).
IBM_COUNTS = np.asarray(
    [
        [[4288, 3904], [4373, 3819], [7473, 719]],
        [[1589, 6603], [4033, 4159], [3520, 4672]],
        [[5488, 2704], [6834, 1358], [3593, 4599]],
        [[6167, 2025], [2403, 5789], [3515, 4677]],
    ],
    dtype=np.float64,
)

# Detector calibration: diagonal readout-confusion POVM element for
# outcome "0" (P(0|0)=0.972, P(0|1)=0.093), completed by I - E.
READOUT_E0 = np.diag([0.972, 0.093]).astype(complex)


def calibrated_povm_matrix() -> np.ndarray:
    """(3, 2, 4) bloch-row POVM: RY- and RX-rotated and computational
    measurements of the readout-calibrated effects."""
    povm_z = [READOUT_E0, np.eye(2) - READOUT_E0]
    povm_x = [RX(np.pi / 2).H.as_channel().transform(qt.Qobj(e)).matrix for e in povm_z]
    povm_y = [RY(np.pi / 2).H.as_channel().transform(qt.Qobj(e)).matrix for e in povm_z]
    return np.stack(
        [
            [np.asarray(qt.Qobj(e).bloch, dtype=np.float64) for e in povm]
            for povm in (povm_y, povm_x, povm_z)
        ]
    )


def tetrahedral_input_states() -> list:
    """|0> plus three Ry/Rz rotations: a tetrahedral state basis
    (notebooks/Teleportation.ipynb cell 4)."""
    ry = RY(np.arccos(-1 / 3)).as_channel()
    rz23 = RZ(np.pi * 2 / 3).as_channel()
    rz43 = RZ(np.pi * 4 / 3).as_channel()
    s1 = qt.Qobj(np.diag([1.0, 0.0]).astype(complex))
    s2 = ry.transform(s1)
    s3 = rz23.transform(s2)
    s4 = rz43.transform(s2)
    return [s1, s2, s3, s4]


def main(args=None) -> None:
    parse_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]), args)
    target = Id.as_channel()
    tmg = qt.ProcessTomograph(target, input_states=tetrahedral_input_states(), key=17)
    povm_matrix = calibrated_povm_matrix()
    tmg.experiment(8192, povm_matrix)  # dummy run fixes the design buffers
    tmg.results = IBM_COUNTS  # real IBMQ data in

    est = tmg.point_estimate("lifp")
    # entanglement fidelity of the teleportation vs the ideal identity
    fid = float(np.dot(target.choi.bloch, est.choi.bloch))
    print(f"teleportation entanglement fidelity (lifp estimate): {fid:.4f}")

    epsilons = np.logspace(-3, -0.01, 30)
    band = qt.MomentFidelityProcessInterval(tmg, target_process=target)
    (fmin, fmax), _ = band(1 - epsilons)
    print(
        f"moment fidelity band @95%: [{np.clip(fmin, 0, 1)[_nearest(epsilons, 0.05)]:.4f}, "
        f"{np.clip(fmax, 0, 1)[_nearest(epsilons, 0.05)]:.4f}]"
    )

    poly = qt.PolytopeProcessInterval(tmg, n_points=100, target_channel=target)
    (pmin, pmax), _ = poly(1 - epsilons)
    print(
        f"polytope fidelity band @95%: [{np.clip(pmin, 0, 1)[_nearest(epsilons, 0.05)]:.4f}, "
        f"{np.clip(pmax, 0, 1)[_nearest(epsilons, 0.05)]:.4f}]"
    )


def _nearest(grid: np.ndarray, value: float) -> int:
    return int(np.argmin(np.abs(grid - value)))


if __name__ == "__main__":
    main()
