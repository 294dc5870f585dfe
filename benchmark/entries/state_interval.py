"""Entry: `BootstrapStateInterval(tmg, key=..., **options).setup()` and its
quantiles, on a tomograph set up once from the seed.

The benchmark draws the experiment itself (NumPy, from the seed) and hands
it to the tomograph through its `results`; the point estimate and every
interval are the program's. The check holds the counts the timed path's
sampler drew in each checked call to the multinomial of the point
estimate, and rebuilds the design, the point estimate and the call's
estimates and distances from those counts with the plain reference."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import state as ref

CAPTURE = {
    "counts": "quantpy_tpu_torch.tomography.state_core.simulate_experiment",
    "distances": "quantpy_tpu_torch.tomography.bootstrap_core._distance_batch",
}
#: resamples the reference estimates at once
BLOCK = 4096
COMPARED = checks.COMPARED


def experiment(config: dict, seed: int) -> np.ndarray:
    """The configured state's experiment, (m, p) counts drawn from `seed`."""
    if (config["state"], config["povm"]) != ("ghz", "proj-set"):
        raise ValueError("the state entries draw GHZ states under the proj-set POVM")
    n = config["n_qubits"]
    probs = ref.probabilities(ref.proj_set_povm(n), ref.ghz_bloch(n))
    return ref.draw_counts(np.random.default_rng(seed), probs, config["shots"])


def tomograph(config: dict, seed: int, device):
    """The user's StateTomograph on the benchmark's experiment, and its
    counts."""
    import quantpy_tpu_torch as qt

    counts = experiment(config, seed)
    tmg = qt.StateTomograph(qt.GHZ(config["n_qubits"]), key=seed, device=device,
                            dtype=getattr(torch, config["dtype"]))
    tmg.experiment(config["shots"], config["povm"])
    tmg.results = counts
    return tmg, counts


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        import quantpy_tpu_torch as qt

        checks.require_precision(config)
        self.interval = qt.BootstrapStateInterval
        self.tmg, self.counts = tomograph(config, seed, devices[0])
        c = traffic["center"]
        self.tmg.point_estimate(c["method"], max_iter=c["max_iter"], tol=c["tol"])
        self.options = traffic["options"]
        self.levels = np.asarray(traffic["levels"], dtype=np.float64)

    def call(self, key: int):
        iv = self.interval(self.tmg, key=key, **self.options)
        iv.setup()
        return iv.distances, iv(self.levels)[0]

    def release(self) -> dict:
        inputs = {"experiment": self.counts,
                  "center": np.asarray(self.tmg.reconstructed_state.bloch, dtype=np.float64)}
        self.tmg = None
        return inputs


def center_tol(center: dict) -> float | None:
    """The point estimate's RrhoR stop, as the program documents `tol`:
    tol * 1e-3, floored at ten float32 epsilons."""
    if center["method"] != "mle-rhor":
        return None
    return max(10 * float(np.finfo(np.float32).eps), center["tol"] * 1e-3)


def reference_run(config, traffic, inputs, calls, device, dtype):
    """The reference in `dtype`: its point estimate from the experiment (the
    iterates around its stop; the distances are to the stop), and for each
    checked call the distances of its estimates from each shard's
    counts, in the shard's order, and their quantiles."""
    n = config["n_qubits"]
    w = ref.design(ref.proj_set_povm(n), config["shots"], dtype, device)
    c, opts = traffic["center"], traffic["options"]
    exp = torch.as_tensor(inputs["experiment"], dtype=dtype, device=device)
    around = ref.estimate(ref.frequencies(exp), w, n, c["method"], c["max_iter"], center_tol(c),
                          around_stop=True)
    center = around[len(around) // 2]
    out = []
    for pairs in calls:
        dist = []
        for counts, _ in pairs:
            parts = []
            for blk in counts.split(BLOCK):
                f = ref.frequencies(blk.to(device=device, dtype=dtype))
                est = ref.estimate(f, w, n, opts["method"], opts.get("max_iter", 0))
                parts.append(ref.hs_distance(est, center, n).double().cpu().numpy())
            dist.append(np.concatenate(parts))
        out.append((dist, ref.quantiles(np.sort(np.concatenate(dist)), traffic["levels"])))
    return [a.double().cpu().numpy() for a in around], out


def probabilities(config: dict, center: np.ndarray):
    """device -> the (m, p) outcome probabilities of `center`, float64."""
    p = ref.probabilities(ref.proj_set_povm(config["n_qubits"]), center)
    return lambda device: torch.as_tensor(p, dtype=torch.float64, device=device)


def expected(traffic: dict, devices) -> dict:
    """What `checks.exact_faults` expects of a call over `devices`: a shard
    per card, a thread per distinct device."""
    return {"n_points": int(traffic["options"]["n_points"]), "shards": len(devices),
            "threads": len(set(devices))}


def readings(config, traffic, inputs, samples, devices, control: bool = False) -> dict:
    """The compared numbers (`checks.readings`)."""
    return checks.readings(
        lambda calls, dtype: reference_run(config, traffic, inputs, calls, devices[0], dtype),
        probabilities(config, inputs["center"]), config["n_qubits"], config["shots"], inputs,
        samples, expected(traffic, devices), control)


def verify(config, traffic, inputs, samples, limits, devices) -> list:
    r = readings(config, traffic, inputs, samples, devices)
    return [(name, float(r[name]), float(limits[name])) for name in COMPARED]
