"""CLI: process point estimate + confidence intervals from real QPT records.

Port of quantpy_tpu/cli/process_interval.py. Reads a JSON document with
`povm_matrix`, `input_states`, and per-input-state `outcomes`, builds a
ProcessTomograph over the given input basis, injects the counts, and emits
the Choi bloch vector plus (optionally) fidelity bands and Hilbert-Schmidt
radii.

`--method` selects the estimator (lifp/pgdb/states/dys), `--interval` the
CI family (moment/bootstrap/mhmc/polytope), `--device` where it runs
(default cuda).
"""

from __future__ import annotations

import math

import numpy as np

from ..channel import Channel, depolarizing
from ..qobj import Qobj
from ..tomography.interval import (
    BootstrapProcessInterval,
    MHMCProcessInterval,
    MomentFidelityProcessInterval,
    MomentInterval,
    PolytopeProcessInterval,
)
from ..tomography.process import ProcessTomograph
from .common import build_parser, emit, load_input, validate_record


def _build_tomograph(input_data: dict, device=None) -> ProcessTomograph:
    results = np.asarray(input_data["outcomes"], dtype=np.float64)
    povm_matrix = np.asarray(input_data["povm_matrix"], dtype=np.float64)
    n_qubits = int(round(math.log2(povm_matrix.shape[-1]) / 2))
    input_states = [Qobj(np.asarray(b)) for b in input_data["input_states"]]
    # the channel argument only seeds the simulator (a depolarizing
    # placeholder); the design and the counts come from the record
    tmg = ProcessTomograph(
        depolarizing(n_qubits=n_qubits), input_states=input_states, device=device
    )
    # one child per input state on the parent's device, dtype and generator
    tmg.tomographs = tmg._new_tomographs()
    for child, counts in zip(tmg.tomographs, results):
        child.povm_matrix = povm_matrix
        child.results = counts
    return tmg


def _radius_interval(tmg, name: str, method: str, n_points: int):
    if name in ("moment", "polytope", "sugiyama"):
        # polytope emits bands; sugiyama is state-only: moment fallback
        return MomentInterval(tmg)
    if name == "bootstrap":
        return BootstrapProcessInterval(tmg, n_points=n_points, method=method)
    if name == "mhmc":
        return MHMCProcessInterval(
            tmg, n_points=n_points, method=method, use_new_estimate=False
        )
    raise ValueError(f"Unknown interval family {name!r}")


def run(
    input_data: dict,
    no_ci: bool = False,
    method: str = "lifp",
    interval: str = "moment",
    n_points: int = 500,
    device=None,
) -> dict:
    """The CLI's output for one record, computed on `device` (default:
    `config.get_device()`)."""
    validate_record(input_data, "process")
    tmg = _build_tomograph(input_data, device)

    output: dict = {}
    est = tmg.point_estimate(method=method, cptp=False)
    output["process"] = [float(x) for x in est.choi.bloch]
    if no_ci:
        return output

    conf_levels = np.asarray(input_data.get("conf_levels", [0.95]))
    if "target_process" in input_data:
        target = Channel(Qobj(np.asarray(input_data["target_process"])))
        if interval == "polytope":
            band = PolytopeProcessInterval(
                tmg, n_points=n_points, target_channel=target
            )
        else:
            band = MomentFidelityProcessInterval(tmg, target_process=target)
        (fmin, fmax), _ = band(conf_levels)
        output["fidelity_min"] = [float(x) for x in np.maximum(fmin, 0)]
        output["fidelity_max"] = [float(x) for x in np.minimum(fmax, 1)]

    radius = _radius_interval(tmg, interval, method, n_points)
    dist, _ = radius(conf_levels)
    output["hs_radius"] = [float(x) for x in np.atleast_1d(dist)]
    return output


def main(args=None):
    parsed = build_parser(
        __doc__, methods=("lifp", "pgdb", "states", "dys")
    ).parse_args(args)
    emit(
        run(
            load_input(parsed.input),
            no_ci=parsed.no_ci,
            method=parsed.method,
            interval=parsed.interval,
            n_points=parsed.n_points,
            device=parsed.device,
        ),
        parsed.output,
    )


if __name__ == "__main__":
    main()
