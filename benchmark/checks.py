"""What decides `correct`: exact checks of what the timed path returned,
the moments of the counts its sampler drew, and the gaps between its
numbers and the plain reference's.

In each checked call the harness keeps, per shard, the counts the sampler
drew and the per-resample distances the path computed from them. Exact:
every row of counts is non-negative whole numbers summing to the shots;
there is one shard per card, each drawn in the thread of its own card,
with its share of the resamples and one distance per resample; the
interval returns as many distances as resamples were asked for, exactly
the sort of the shards' distances. Moments, as z-scores over a shard's
resamples: the mean count of each outcome against shots * p, and the
summed squared deviation from shots * p against the multinomial's
sum of shots * p * (1 - p), with p the probabilities of the center the
interval draws from (the program's point estimate, itself held to the
reference by `center_gap`). Gaps, each over the median of the
reference's distances (the interval's own scale): the point estimate's
distance to the reference's, and the widest difference of a resample's
distance or a quantile. The control is the reference in the program's
place one precision below the configuration's: float32 with TF32 products.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

REFERENCE_DTYPE = torch.float64
CONTROL_DTYPE = torch.float32
COMPARED = ("exact_faults", "count_mean_z", "count_var_z", "center_gap", "dist_gap")
#: outcomes whose expected count summed over a shard's resamples is under
#: this are left out of the moments, where the normal law of the mean fails
MIN_EXPECTED = 25.0


@contextlib.contextmanager
def tf32():
    """float32 products in TF32 (the control's precision), restored on exit."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


def require_precision(config: dict) -> None:
    """Raise where float32 products do not run as the configuration states
    (`tf32`): the program sets them when it is imported."""
    on = (torch.backends.cuda.matmul.allow_tf32
          or torch.get_float32_matmul_precision() != "highest")
    if on != bool(config["tf32"]):
        raise RuntimeError(f"TF32 products are {'on' if on else 'off'}; the configuration "
                           f"states tf32={config['tf32']}")


def shards(captured: list) -> tuple[list, int]:
    """(counts, distances) per shard of a checked call, and the number of
    threads that drew them. Each shard's thread draws its counts and then
    computes its distances, so the two pair up in order within a thread."""
    by_thread = {}
    for thread, kind, tensor in captured:
        by_thread.setdefault(thread, {"counts": [], "distances": []})[kind].append(tensor)
    pairs = []
    for got in by_thread.values():
        if len(got["counts"]) != len(got["distances"]):
            return [], len(by_thread)
        pairs += list(zip(got["counts"], got["distances"]))
    return pairs, len(by_thread)


def exact_faults(pairs: list, threads: int, shots: float, returned, expect: dict) -> int:
    """Faults a sound path never has: rows of counts (..., p) that are not
    non-negative whole numbers summing to `shots`; another number of shards
    than expect['shards'] or of drawing threads than expect['threads']; a
    shard without its share of expect['n_points'] resamples, or whose
    distances are not one per resample; returned distances that are not
    expect['n_points'], exactly the sort of the shards' distances."""
    if not pairs:
        return 1
    faults = int(len(pairs) != expect["shards"]) + int(threads != expect["threads"])
    share = expect["n_points"] // expect["shards"]
    for counts, dist in pairs:
        c = counts.detach()
        ok = torch.isfinite(c) & (c >= 0) & (c == torch.round(c))
        faults += int((~(ok.all(-1) & (c.sum(-1) == shots))).sum())
        faults += int(counts.shape[0] != share) + int(dist.shape != counts.shape[:1])
    computed = np.sort(np.concatenate([d.detach().cpu().numpy().astype(np.float64)
                                       for _, d in pairs]))
    returned = np.asarray(returned, dtype=np.float64)
    faults += int(returned.shape != (expect["n_points"],))
    faults += int(computed.shape != returned.shape or not np.array_equal(computed, returned))
    return faults


def count_moments(pairs: list, probabilities, shots: float) -> tuple[float, float]:
    """Two z-scores of a shard's counts c (B resamples) against the
    multinomial of p, the widest over the shards. The mean: per outcome,
    (mean c - shots p) / sqrt(shots p (1 - p) / B), outcomes expected under
    MIN_EXPECTED counts in all B resamples left out. The variance: with
    e_j = sum over the outcomes kept of (c_jk - shots p_k)^2, whose
    expectation is sum shots p (1 - p), (mean e - that) / (std e / sqrt(B)).
    Counts without spread read infinite. `probabilities(device)` gives p,
    shaped as one resample's counts."""
    z_mean, z_var = 0.0, 0.0
    for counts, _ in pairs:
        c = counts.detach().to(torch.float64)
        b = c.shape[0]
        c = c.reshape(b, -1)
        p = probabilities(c.device).reshape(-1)
        mu, sig2 = shots * p, shots * p * (1.0 - p)
        keep = (b * mu >= MIN_EXPECTED) & (sig2 > 0)
        dev = c[:, keep] - mu[keep]
        z = dev.mean(0).abs() / torch.sqrt(sig2[keep] / b)
        e = (dev**2).sum(-1)
        spread = float(e.std()) / np.sqrt(b) if b > 1 else 0.0
        z_mean = max(z_mean, float(z.max()))
        z_var = max(z_var, abs(float(e.mean() - sig2[keep].sum())) / spread if spread else np.inf)
    return z_mean, z_var


def hs(a, b, n: int) -> float:
    """Hilbert-Schmidt distance of two bloch vectors of n qubits."""
    return float(np.sqrt(2**n * np.sum((np.asarray(a) - np.asarray(b)) ** 2) / 2))


def widest(outputs: list, reference: list) -> float:
    """The widest difference of a resample's distance or a quantile between
    two runs over the same checked calls, [(per-shard distances,
    quantiles)]; infinite where a number is not finite."""
    gaps = [0.0]
    for (dist, q), (dist_ref, q_ref) in zip(outputs, reference, strict=True):
        for d, d_ref in zip(dist, dist_ref, strict=True):
            d = np.asarray(d, dtype=np.float64)
            if d.shape != d_ref.shape:
                return np.inf
            gaps.append(np.max(np.abs(d - d_ref)))
        gaps.append(np.max(np.abs(np.asarray(q) - q_ref)))
    gaps = np.asarray(gaps, dtype=np.float64)
    return float(gaps.max()) if np.isfinite(gaps).all() else np.inf


def center_gap(center, around: list, n: int) -> float:
    """The distance from a point estimate to the nearest of the reference's
    iterates around its stop: an iterative point estimate in another
    precision may cross the stop's tolerance one step apart."""
    gaps = [hs(center, a, n) for a in around]
    return min(gaps) if all(np.isfinite(gaps)) else np.inf


def readings(reference_run, probabilities, n_hs: int, shots: float, inputs: dict, samples: list,
             expect: dict, control: bool = False) -> dict:
    """The compared numbers of the program; with `control`, also the gaps of
    the control, as control_<name>.

    `reference_run(pairs_per_call, dtype)` gives the reference's point
    estimate (the iterates around its stop) and, per checked call, its
    per-shard distances and quantiles; `probabilities` is as in
    `count_moments`; `n_hs` is the qubit count of the distance (2n for Choi
    matrices); `inputs["center"]` is the program's point estimate; `expect`
    as in `exact_faults`."""
    calls = [(*shards(captured), d, q) for _, (captured, d, q) in samples]
    faults = sum(exact_faults(p, t, shots, d, expect) for p, t, d, _ in calls) if calls else 1
    if faults:
        return {"exact_faults": float(faults), **{k: np.inf for k in COMPARED[1:]}}
    pairs = [p for p, _, _, _ in calls]
    moments = [count_moments(p, probabilities, shots) for p in pairs]
    around, ref_out = reference_run(pairs, REFERENCE_DTYPE)
    scale = float(np.median(np.concatenate([d for dist, _ in ref_out for d in dist])))
    program = [([d.detach().cpu().numpy() for _, d in p], q) for p, _, _, q in calls]
    out = {"exact_faults": 0.0,
           "count_mean_z": max(z for z, _ in moments),
           "count_var_z": max(v for _, v in moments),
           "center_gap": center_gap(inputs["center"], around, n_hs) / scale,
           "dist_gap": widest(program, ref_out) / scale}
    if control:
        with tf32():
            c_around, c_out = reference_run(pairs, CONTROL_DTYPE)
        out["control_center_gap"] = center_gap(c_around[len(c_around) // 2], around, n_hs) / scale
        out["control_dist_gap"] = widest(c_out, ref_out) / scale
    return out
