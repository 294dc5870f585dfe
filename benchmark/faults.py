"""Faults planted under the sampler's attribute, `state_core.simulate_experiment`,
to read what the check makes of them: on the card by `calibrate --fault`,
on the CPU by the harness's tests. The benchmark's own runs never plant
one.

Each fault maps the original to a function of the same signature
(generator, povm_matrix, bloch, n_measurements) -> counts."""

from __future__ import annotations

import torch

SAMPLER = "quantpy_tpu_torch.tomography.state_core.simulate_experiment"


def _probabilities(povm_matrix, bloch):
    from quantpy_tpu_torch.tomography import state_core

    p = state_core.experiment_probabilities(povm_matrix, bloch)
    return p / p.sum(-1, keepdim=True)


def deterministic(original):
    """No randomness: every resample gets the expected counts, rounded so
    that each POVM's counts still sum to its shots (largest remainders)."""

    def broken(generator, povm_matrix, bloch, n_measurements):
        p = _probabilities(povm_matrix, bloch)
        n = torch.as_tensor(n_measurements, dtype=p.dtype, device=p.device)
        expect = p * n.expand(p.shape[:-1])[..., None]
        counts = torch.floor(expect)
        short = (n.expand(p.shape[:-1]) - counts.sum(-1)).round().long()
        order = torch.argsort(counts - expect, dim=-1)  # largest remainder first
        rank = torch.argsort(order, dim=-1)
        return counts + (rank < short[..., None]).to(counts.dtype)

    return broken


def uniform(original):
    """The sampler run on the wrong probabilities: every outcome of a POVM
    alike."""

    def broken(generator, povm_matrix, bloch, n_measurements):
        from quantpy_tpu_torch.ops.sampling import sample_multinomial

        p = torch.ones_like(_probabilities(povm_matrix, bloch))
        n = torch.as_tensor(n_measurements, dtype=p.dtype, device=p.device)
        return sample_multinomial(generator, n.expand(p.shape[:-1]), p / p.shape[-1])

    return broken


def half(original):
    """Half the resamples drawn, and so re-estimated and returned."""

    def broken(generator, povm_matrix, bloch, n_measurements):
        counts = original(generator, povm_matrix, bloch, n_measurements)
        return counts[: max(counts.shape[0] // 2, 1)]

    return broken


SAMPLER_FAULTS = {"deterministic": deterministic, "uniform": uniform, "half": half}
