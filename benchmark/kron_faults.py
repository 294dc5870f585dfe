"""Faults planted under the kron sampler's attribute, `kron_core.kron_simulate`,
to read what the check makes of them: on the card by this module's command,
on the CPU by the harness's tests. The benchmark's own runs never plant one.

Each fault maps the original to a function of the same signature
(generator, povm1, bloch, n_shots) -> counts (..., m1^n, p1^n).

    python3 -m benchmark.kron_faults --workload <cell> --seeds 11,12 --fault deterministic

prints, per seed, one JSON line of the compared numbers of the cell's
set-up and its checked calls with the fault planted (`calibrate.readings`).
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

SAMPLER = "quantpy_tpu_torch.tomography.kron_core.kron_simulate"


def _probabilities(povm1, bloch):
    from quantpy_tpu_torch.tomography import kron_core

    n = int(round(math.log(bloch.shape[-1], 4)))
    p = kron_core.kron_probs(povm1, n, bloch)
    return p / p.sum(-1, keepdim=True)


def deterministic(original):
    """No randomness: every resample gets the expected counts, rounded so
    that each setting's counts still sum to its shots (largest remainders)."""

    def broken(generator, povm1, bloch, n_shots):
        p = _probabilities(povm1, bloch)
        expect = p * float(n_shots)
        counts = torch.floor(expect)
        short = (float(n_shots) - counts.sum(-1)).round().long()
        order = torch.argsort(counts - expect, dim=-1)  # largest remainder first
        rank = torch.argsort(order, dim=-1)
        return counts + (rank < short[..., None]).to(counts.dtype)

    return broken


def uniform(original):
    """The sampler run on the wrong probabilities: every outcome of a
    setting alike."""

    def broken(generator, povm1, bloch, n_shots):
        from quantpy_tpu_torch.ops.sampling import sample_multinomial

        p = torch.ones_like(_probabilities(povm1, bloch))
        n = torch.full(p.shape[:-1], float(n_shots), dtype=p.dtype, device=p.device)
        return sample_multinomial(generator, n, p / p.shape[-1])

    return broken


SAMPLER_FAULTS = {"deterministic": deterministic, "uniform": uniform}


def main(argv=None) -> int:
    from benchmark import calibrate, harness

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--calls", type=int, default=None,
                        help="calls per seed (default: the cell's checked_calls)")
    parser.add_argument("--fault", choices=sorted(SAMPLER_FAULTS), required=True)
    args = parser.parse_args(argv)
    root = Path.cwd()
    if not torch.cuda.is_available():
        harness.log("no result: torch.cuda.is_available() is false")
        return 3
    calls = args.calls or int(harness.Cell.load(root, args.workload).check["checked_calls"])
    for seed in (int(s) for s in args.seeds.split(",")):
        with harness.spans.wrapped({args.fault: SAMPLER_FAULTS[args.fault]},
                                   {args.fault: SAMPLER}):
            r = calibrate.readings(root, args.workload, seed, calls, control=False)
        r["fault"] = args.fault
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
