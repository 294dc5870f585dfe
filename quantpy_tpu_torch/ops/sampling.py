"""Measurement-outcome sampling (port of quantpy_tpu/ops/sampling.py).

Multinomial counts by recursive binary splitting: each of ceil(log2(m))
levels draws every block's left-half count as one batched conditional
binomial (`torch.binomial`). Randomness comes only from the explicit
`torch.Generator` passed in, which must live on the tensors' device.
"""

from __future__ import annotations

import torch

from ..config import as_real

__all__ = ["sample_multinomial"]


def _multinomial_binary_split(generator, n_trials, probs):
    """Exact multinomial sampling by recursive binary splitting.

    `probs` is normalized along the last axis; the outcome axis is
    zero-padded to a power of two (Binomial(n, 0) == 0, so padding never
    receives counts).
    """
    m = probs.shape[-1]
    m_pad = 1 << (m - 1).bit_length()
    if m_pad != m:
        probs = torch.nn.functional.pad(probs, (0, m_pad - m))
    batch_shape = tuple(probs.shape[:-1])
    counts = n_trials.reshape(batch_shape + (1,))
    levels = m_pad.bit_length() - 1
    block_sums = [probs]  # block masses per level, finest first
    for _ in range(levels):
        prev = block_sums[-1]
        block_sums.append(prev[..., 0::2] + prev[..., 1::2])
    block_sums.reverse()  # block_sums[k] has 2^k blocks
    for level in range(levels):
        total = block_sums[level]
        lmass = block_sums[level + 1][..., 0::2]
        positive = total > 0
        ratio = torch.where(positive, lmass / torch.where(positive, total, 1.0), 0.0)
        # rounding can push the ratio one ulp past 1, where the binomial
        # returns NaN; clamp to the valid range
        ratio = ratio.clamp(0.0, 1.0)
        left = torch.binomial(counts, ratio, generator=generator)
        counts = torch.stack([left, counts - left], dim=-1).reshape(batch_shape + (-1,))
    return counts[..., :m]


def sample_multinomial(generator, n_trials, probs):
    """Multinomial counts with outcomes along the last axis of `probs`.

    Parameters
    ----------
    generator : torch.Generator on the device of `probs`
    n_trials : number or tensor broadcastable to probs.shape[:-1]
    probs : (..., n_outcomes) tensor; clipped to [0, 1] and renormalized.

    Returns float counts of the dtype of `probs`.
    """
    probs = as_real(probs).clamp(0.0, 1.0)
    probs = probs / probs.sum(-1, keepdim=True)
    n_trials = as_real(n_trials, like=probs).expand(probs.shape[:-1])
    return _multinomial_binary_split(generator, n_trials.contiguous(), probs)
