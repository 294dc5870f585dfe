"""Real-measurement-record workflow: raw counts -> results setter ->
point estimates -> the full interval stack.

Port of examples/real_records.py, the counterpart of the reference's
real-data notebooks (notebooks/Ion Data.ipynb: trapped-ion QPT of an
RX(pi/2) gate via per-tomograph `results` injection, cells 4-9;
polytopes/notebooks/IBM teleportation.ipynb: IBMQ counts -> polytope
fidelity bounds). It reads the two bundled records of the checkout
(examples/data/*.json, provenance in examples/data/make_records.py), whose
outcomes come from a device model the analysis does NOT know: hidden
coherent over-rotation / depolarization plus per-qubit readout confusion,
the model mismatch that makes real records different from simulations.

Workflow per record (the notebooks' shape):
1. build a tomograph for the *nominal* target and a dummy experiment to fix
   the measurement design,
2. overwrite `results` with the recorded counts,
3. point-estimate and compare to the nominal target,
4. run the interval stack: Moment/Sugiyama radii, bootstrap CDF, polytope
   and moment fidelity bands w.r.t. the target.

Run:  python -m quantpy_tpu_torch.examples.real_records [--boot 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.examples import parse_args
from quantpy_tpu_torch.operator import CNOT

#: the records bundled with the repository (read, never written)
DATA = pathlib.Path(__file__).resolve().parents[2] / "examples" / "data"


def analyze_state_record(n_boot: int = 256) -> dict:
    """Noisy GHZ(2) preparation record -> estimates + every state CI."""
    with open(DATA / "ghz2_state_record.json") as fp:
        record = json.load(fp)
    target = qt.Qobj(np.asarray(record["target_state"]))
    conf = np.asarray(record["conf_levels"])

    tmg = qt.StateTomograph(target, key=2)
    shots = int(np.sum(record["outcomes"][0]))
    tmg.experiment(shots, "proj-set")  # dummy run fixes the design buffers
    tmg.results = np.asarray(record["outcomes"], dtype=np.float64)  # real data in

    est = tmg.point_estimate("mle")
    fid = 1 - float(qt.if_dst(est, target))
    out = {"fidelity_to_target": fid}

    moment = qt.MomentInterval(tmg)
    out["moment_radius"] = np.asarray(moment(conf)[0]).tolist()
    sugiyama = qt.SugiyamaInterval(tmg)
    out["sugiyama_radius"] = np.asarray(sugiyama(conf)[0]).tolist()
    boot = qt.BootstrapStateInterval(tmg, n_points=n_boot, method="mle-rhor")
    out["bootstrap_radius"] = np.asarray(boot(conf)[0]).tolist()
    poly = qt.PolytopeStateInterval(tmg, n_points=200, target_state=target)
    (fmin, fmax), _ = poly(conf)
    out["polytope_fidelity_band"] = [np.asarray(fmin).tolist(), np.asarray(fmax).tolist()]
    return out


def analyze_process_record(n_boot: int = 64) -> dict:
    """Noisy CNOT QPT record -> lifp/pgdb estimates + process CIs."""
    with open(DATA / "cnot2_process_record.json") as fp:
        record = json.load(fp)
    target = CNOT.as_channel()
    conf = np.asarray(record["conf_levels"])

    tmg = qt.ProcessTomograph(target, input_states="proj4", key=3)
    shots = int(np.sum(record["outcomes"][0][0]))
    tmg.experiment(shots, "proj-set")
    tmg.results = np.asarray(record["outcomes"], dtype=np.float64)  # real data in

    est = tmg.point_estimate("lifp")
    est_pgdb = tmg.point_estimate("pgdb", n_iter=50)
    # the Choi-bloch dot product of the Ion Data notebook (cell 6) equals
    # Tr(C_t C_e)/4^n: the entanglement fidelity for a unitary target
    fid = float(np.dot(target.choi.bloch, est.choi.bloch))
    out = {
        "entanglement_fidelity": fid,
        "pgdb_vs_lifp_hs": float(qt.hs_dst(est.choi, est_pgdb.choi)),
    }

    band = qt.MomentFidelityProcessInterval(tmg, target_process=target)
    (fmin, fmax), _ = band(conf)
    out["moment_fidelity_band"] = [np.asarray(fmin).tolist(), np.asarray(fmax).tolist()]
    boot = qt.BootstrapProcessInterval(tmg, n_points=n_boot)
    out["bootstrap_radius"] = np.asarray(boot(conf)[0]).tolist()
    return out


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--boot", type=int, default=256)
    parsed = parse_args(parser, args)

    state_out = analyze_state_record(parsed.boot)
    print("== state record (noisy GHZ preparation) ==")
    print(json.dumps(state_out, indent=2))
    process_out = analyze_process_record(max(parsed.boot // 4, 16))
    print("== process record (noisy CNOT) ==")
    print(json.dumps(process_out, indent=2))


if __name__ == "__main__":
    main()
