"""Measurement-outcome sampling (port of quantpy_tpu/ops/sampling.py).

Multinomial counts by recursive binary splitting: each of ceil(log2(m))
levels draws every block's left-half count as one batched conditional
binomial (`torch.binomial`). The chain sampler (`method="chain"`) draws the
same distribution as m - 1 sequential conditional binomials, as
`jax.random.multinomial` does; it is the independent exact sampler that a
faster one is held to. Randomness comes only from the explicit
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


def _multinomial_chain(generator, n_trials, probs):
    """Exact multinomial sampling by sequential conditional binomials.

    Outcome j draws Binomial(remaining trials, p_j / remaining mass) for
    j = 0..m-2, and the last outcome takes the rest: one `torch.binomial`
    call per outcome over the whole batch. `probs` is normalized along the
    last axis."""
    m = probs.shape[-1]
    # mass of outcomes j..m-1, for each j
    tail = probs.flip(-1).cumsum(-1).flip(-1)
    remaining = n_trials
    counts = []
    for j in range(m - 1):
        total = tail[..., j]
        positive = total > 0
        ratio = torch.where(positive, probs[..., j] / torch.where(positive, total, 1.0), 0.0)
        # the clamp of the binary split: rounding can push the ratio past 1
        ratio = ratio.clamp(0.0, 1.0)
        draw = torch.binomial(remaining, ratio, generator=generator)
        counts.append(draw)
        remaining = remaining - draw
    counts.append(remaining)
    return torch.stack(counts, dim=-1)


def sample_multinomial(generator, n_trials, probs, shape=None, method: str = "binary"):
    """Multinomial counts with outcomes along the last axis of `probs`.

    Parameters
    ----------
    generator : torch.Generator on the device of `probs`
    n_trials : number or tensor broadcastable to the batch shape
    probs : (..., n_outcomes) tensor; clipped to [0, 1] and renormalized.
    shape : optional batch shape of the result (the prefix before the
        outcome axis); `probs` is broadcast to shape + probs.shape[-1:]
    method : 'binary' (log-depth binary splitting, the default) or 'chain'
        (m - 1 sequential conditional binomials). Both are exact samplers
        of the same distribution; their streams differ.

    Returns float counts of the dtype of `probs`.
    """
    if method not in ("binary", "chain"):
        raise ValueError(f"method must be 'binary' or 'chain', got {method!r}")
    probs = as_real(probs).clamp(0.0, 1.0)
    probs = probs / probs.sum(-1, keepdim=True)
    if shape is not None:
        probs = probs.expand(tuple(shape) + probs.shape[-1:])
    n_trials = as_real(n_trials, like=probs).expand(probs.shape[:-1]).contiguous()
    if method == "chain":
        return _multinomial_chain(generator, n_trials, probs)
    return _multinomial_binary_split(generator, n_trials, probs)
