"""Entry: `BootstrapStateInterval(tmg, key=..., **options).setup()` and its
quantiles on a tomograph in kron mode (the design never materialized),
set up once from the seed.

The benchmark draws the experiment itself (NumPy, from the seed) and hands
it to the tomograph through its `results`; the point estimate and every
interval are the program's. The kron bootstrap draws and estimates its
resamples in chunks, each a call of `kron_core.kron_simulate` and of
`kron_core._distance_batch`; the check joins a call's chunks in order into
one shard, holds its counts to the multinomial of the point estimate, and
rebuilds the point estimate and each chunk's estimates and distances from
those counts with the plain reference (`benchmark/reference/kron_state.py`),
chunk by chunk as the program batched them: each RrhoR loop stops on its
own batch's largest change, and the reference follows the same stop.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.entries.state_interval import center_tol, expected
from benchmark.reference import kron_state as ref

CAPTURE = {
    "counts": "quantpy_tpu_torch.tomography.kron_core.kron_simulate",
    "distances": "quantpy_tpu_torch.tomography.kron_core._distance_batch",
}
COMPARED = checks.COMPARED
KETS = {"w": ref.w_ket, "ghz": ref.ghz_ket}
#: the stop of each chunk's RrhoR loop: `kron_estimate_mle_rhor`'s default
#: tol, which `kron_bootstrap_distances` leaves as it is
CHUNK_TOL = 1e-6


def truth(config: dict) -> np.ndarray:
    """The configured ket, (2^n,)."""
    if config["povm"] != "proj-set":
        raise ValueError("the kron entry draws under the proj-set POVM")
    return KETS[config["state"]](config["n_qubits"])


def experiment(config: dict, seed: int) -> np.ndarray:
    """The configured state's experiment, (3^n, 2^n) counts drawn from `seed`."""
    n = config["n_qubits"]
    bloch = torch.as_tensor(ref.bloch_of_ket(truth(config)))
    return ref.draw_counts(np.random.default_rng(seed), ref.probabilities(bloch, n).numpy(),
                           config["shots"])


def tomograph(config: dict, seed: int, device):
    """The user's StateTomograph in kron mode on the benchmark's experiment,
    and its counts."""
    import quantpy_tpu_torch as qt

    counts = experiment(config, seed)
    tmg = qt.StateTomograph(qt.Qobj(truth(config), is_ket=True), key=seed, device=device,
                            dtype=getattr(torch, config["dtype"]))
    tmg.experiment(config["shots"], config["povm"])
    if not tmg.kron_mode:
        raise RuntimeError("the tomograph did not take kron mode for this design")
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


def joined(captured: list) -> tuple[list, list]:
    """A call's captures with each thread's chunks joined in order into one
    (counts, distances) pair, and each thread's chunk sizes. Chunks that do
    not join (another trailing shape) stay apart, and the check then finds
    more shards than cards."""
    by_thread: dict = {}
    for thread, kind, tensor in captured:
        by_thread.setdefault(thread, {"counts": [], "distances": []})[kind].append(tensor)
    out, sizes = [], []
    for thread, got in by_thread.items():
        for kind in ("counts", "distances"):
            parts = got[kind]
            try:
                out.append((thread, kind, torch.cat(parts) if parts else None))
            except RuntimeError:
                out += [(thread, kind, t) for t in parts]
        sizes.append([int(t.shape[0]) for t in got["counts"]])
    return [x for x in out if x[2] is not None], sizes


def nearest(candidates: list, program: np.ndarray) -> np.ndarray:
    """Of the reference's distances at its iterates around a stop, those
    nearest the program's (the widest difference smallest)."""
    return min(candidates, key=lambda d: float(np.max(np.abs(d - program))))


def reference_run(config, traffic, inputs, calls, sizes, device, dtype):
    """The reference in `dtype`: its point estimate from the experiment (the
    iterates around its stop; the distances are to the stop), and for each
    checked call the distances of its estimates from each chunk's counts,
    in the chunks' order, and their quantiles. In float64 (the reference) a
    chunk's distances are those of its iterate, around the chunk's stop,
    nearest the program's; in any other dtype (the control, in the
    program's place) those at its own stop."""
    n = config["n_qubits"]
    c, opts = traffic["center"], traffic["options"]
    exp = torch.as_tensor(inputs["experiment"], dtype=dtype, device=device)
    around = ref.estimate(ref.frequencies(exp), n, c["method"], c["max_iter"], center_tol(c),
                          around_stop=True)
    center = around[len(around) // 2]
    out = []
    for pairs, call_sizes in zip(calls, sizes, strict=True):
        dist = []
        for (counts, program), chunk_sizes in zip(pairs, call_sizes, strict=True):
            program = program.detach().double().cpu().numpy()
            parts, lo = [], 0
            for blk in counts.split(chunk_sizes):
                f = ref.frequencies(blk.to(device=device, dtype=dtype))
                cands = ref.estimate(f, n, opts["method"], opts.get("max_iter", 0), CHUNK_TOL,
                                     around_stop=True)
                cands = [ref.hs_distance(e, center, n).double().cpu().numpy() for e in cands]
                mine = program[lo: lo + blk.shape[0]]
                lo += blk.shape[0]
                if dtype == checks.REFERENCE_DTYPE:
                    parts.append(nearest(cands, mine))
                else:
                    parts.append(cands[len(cands) // 2])
            dist.append(np.concatenate(parts))
        out.append((dist, ref.quantiles(np.sort(np.concatenate(dist)), traffic["levels"])))
    return [a.double().cpu().numpy() for a in around], out


def probabilities(config: dict, center: np.ndarray):
    """device -> the (3^n, 2^n) outcome probabilities of `center`, float64."""
    p = ref.probabilities(torch.as_tensor(center, dtype=torch.float64), config["n_qubits"])
    return lambda device: p.to(device)


def readings(config, traffic, inputs, samples, devices, control: bool = False) -> dict:
    """The compared numbers (`checks.readings`), on each call's chunks joined
    into one shard per drawing thread."""
    joins = [(i, joined(captured), d, q) for i, (captured, d, q) in samples]
    sizes = [s for _, (_, s), _, _ in joins]
    samples = [(i, (captured, d, q)) for i, (captured, _), d, q in joins]
    return checks.readings(
        lambda calls, dtype: reference_run(config, traffic, inputs, calls, sizes, devices[0],
                                           dtype),
        probabilities(config, inputs["center"]), config["n_qubits"], config["shots"], inputs,
        samples, expected(traffic, devices), control)


def verify(config, traffic, inputs, samples, limits, devices) -> list:
    r = readings(config, traffic, inputs, samples, devices)
    return [(name, float(r[name]), float(limits[name])) for name in COMPARED]
