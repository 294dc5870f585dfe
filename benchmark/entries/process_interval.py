"""Entry: `BootstrapProcessInterval(ptmg, key=..., **options).setup()` and
its quantiles, on a process tomograph set up once from the seed.

The benchmark draws the experiment itself (NumPy, from the seed: every
input state through the configured channel, measured `shots` times per
POVM) and hands it to the tomograph through its `results`. The interval
runs the configuration's CP engine and Dykstra cap. The check holds the
counts the timed path's sampler drew in each checked call to the
multinomial of the point estimate's channel on the inputs, and rebuilds
the point estimate and the call's estimates (lifp, then Dykstra with the
eigendecomposition, stopped as the program stops: when the criterion,
largest over the call's resamples, is not above the tolerance) and Choi
distances from those counts with the plain reference."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import process as ref
from benchmark.reference import state as ref_state

from .state_interval import expected

CAPTURE = {
    "counts": "quantpy_tpu_torch.tomography.state_core.simulate_experiment",
    "distances": "quantpy_tpu_torch.tomography.bootstrap_core._distance_batch",
}
COMPARED = checks.COMPARED
#: the Dykstra cap of point_estimate('lifp'), which takes none: the point
#: estimate stops by its tolerance long before
CENTER_MAX_ITER = 2000


def inputs_of(config: dict) -> np.ndarray:
    if (config["channel"], config["input_states"], config["povm"], config["cp_engine"]) != (
            "depolarizing", "sic", "proj-set", "eigh"):
        raise ValueError("the process entry runs depolarizing channels on SIC inputs under "
                         "proj-set, projected by eigendecomposition")
    return ref.sic_inputs(config["n_qubits"])


def experiment(config: dict, seed: int) -> np.ndarray:
    """(S, m, p) counts of every input state's output, drawn from `seed`."""
    n = config["n_qubits"]
    outputs = ref.depolarized(inputs_of(config), config["p"])
    probs = ref_state.probabilities(ref_state.proj_set_povm(n), outputs)
    return ref_state.draw_counts(np.random.default_rng(seed), probs, config["shots"])


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        import quantpy_tpu_torch as qt

        checks.require_precision(config)
        self.interval = qt.BootstrapProcessInterval
        self.counts = experiment(config, seed)
        self.ptmg = qt.ProcessTomograph(
            qt.depolarizing(config["p"], config["n_qubits"]), input_states=config["input_states"],
            key=seed, device=devices[0], dtype=getattr(torch, config["dtype"]))
        self.ptmg.experiment(config["shots"], config["povm"])
        self.ptmg.results = self.counts
        c = traffic["center"]
        self.ptmg.point_estimate(c["method"], tol=c["cptp_tol"])
        self.options = dict(traffic["options"], cp_engine=config["cp_engine"],
                            cptp_iter=config["cptp_iter"])
        self.levels = np.asarray(traffic["levels"], dtype=np.float64)

    def call(self, key: int):
        iv = self.interval(self.ptmg, key=key, **self.options)
        iv.setup()
        return iv.distances, iv(self.levels)[0]

    def release(self) -> dict:
        choi = self.ptmg.reconstructed_channel.choi.bloch
        inputs = {"experiment": self.counts, "center": np.asarray(choi, dtype=np.float64)}
        self.ptmg = None
        return inputs


def floored_tol(tol: float, config: dict) -> float:
    """A Dykstra tolerance floored, as the program floors it, at eps^1.5 of
    the configuration's precision: the criterion is a squared change."""
    return max(float(np.finfo(np.dtype(config["dtype"])).eps) ** 1.5, tol)


def reference_run(config, traffic, inputs, calls, device, dtype):
    """The reference in `dtype`: its point estimate (Dykstra to the point
    estimate's stop; the iterates around the stop, the distances to the
    stop), and for each checked call the Choi distances of its estimates
    from each shard's counts, all of a shard's resamples projected
    together, in the shard's order, and their quantiles."""
    n = config["n_qubits"]
    ins = inputs_of(config)
    w = ref_state.design(ref_state.proj_set_povm(n), config["shots"], dtype, device)
    c = traffic["center"]
    exp = torch.as_tensor(inputs["experiment"], dtype=dtype, device=device)
    raw = ref.lifp(exp, ins, w, n)
    around, _ = ref.dykstra(ref.choi_to_matrix(raw, n), n, ref.cp_project_eigh, CENTER_MAX_ITER,
                            floored_tol(c["cptp_tol"], config), around_stop=True)
    around = [ref.matrix_to_choi(m, n) for m in around]
    center = around[1]
    tol = floored_tol(config["cptp_tol"], config)
    out = []
    for pairs in calls:
        dist = []
        for counts, _ in pairs:
            raw = ref.lifp(counts.to(device=device, dtype=dtype), ins, w, n)
            m, _ = ref.dykstra(ref.choi_to_matrix(raw, n), n, ref.cp_project_eigh,
                               config["cptp_iter"], tol)
            est = ref.matrix_to_choi(m, n)
            dist.append(ref_state.hs_distance(est, center, 2 * n).double().cpu().numpy())
        out.append((dist, ref_state.quantiles(np.sort(np.concatenate(dist)), traffic["levels"])))
    return [a.double().cpu().numpy() for a in around], out


def probabilities(config: dict, center: np.ndarray):
    """device -> the (S, m, p) outcome probabilities of the channel with Choi
    bloch vector `center` on the inputs, float64."""
    n = config["n_qubits"]
    outputs = ref.channel_outputs(center, inputs_of(config), n)
    p = ref_state.probabilities(ref_state.proj_set_povm(n), outputs)
    return lambda device: torch.as_tensor(p, dtype=torch.float64, device=device)


def readings(config, traffic, inputs, samples, devices, control: bool = False) -> dict:
    """The compared numbers (`checks.readings`)."""
    return checks.readings(
        lambda calls, dtype: reference_run(config, traffic, inputs, calls, devices[0], dtype),
        probabilities(config, inputs["center"]), 2 * config["n_qubits"], config["shots"], inputs,
        samples, expected(traffic, devices), control)


def verify(config, traffic, inputs, samples, limits, devices) -> list:
    r = readings(config, traffic, inputs, samples, devices)
    return [(name, float(r[name]), float(limits[name])) for name in COMPARED]
