"""Token-sampling logit filters (counterpart of ``blt_vqg_tpu/ops/sampling.py``):
temperature, top-k, nucleus (top-p), and one categorical draw per row.

The filters give the JAX functions' logits: temperature -> top-k -> top-p,
filtered entries set to ``NEG``, so a draw over the result respects the
truncated distribution.  :func:`sample_token` draws from an explicit
``torch.Generator`` where the JAX function takes a key; the two never give
the same bits, only the same distribution.
"""

from __future__ import annotations

import torch

NEG = -1e30


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Scales logits by 1/T (T rounded to the logits' dtype, floored at
    1e-6).  T -> 0 approaches greedy, T > 1 flattens."""
    if temperature == 1.0:
        return logits
    t = torch.tensor(temperature, dtype=logits.dtype, device=logits.device)
    return logits / t.clamp_min(1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keeps the logits at or above each row's k-th largest; the rest go to
    ``NEG``.  k <= 0 (or >= the vocab) disables the filter."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keeps the smallest set of tokens whose cumulative
    probability reaches ``p`` (the top token always survives).  p >= 1
    disables the filter."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    # the mass accepted before each token: kept while it is still below p
    cum_before = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(cum_before < p, sorted_logits,
                       torch.full_like(sorted_logits, float("inf")))
    kth = kept.min(dim=-1, keepdim=True).values
    return torch.where(logits < kth, torch.full_like(logits, NEG), logits)


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """temperature -> top-k -> top-p."""
    logits = apply_temperature(logits, temperature)
    logits = apply_top_k(logits, top_k)
    return apply_top_p(logits, top_p)


def sample_token(generator: torch.Generator, logits: torch.Tensor,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """One draw per row [B] int32 from the filtered distribution; filtered
    entries have probability exactly 0."""
    probs = torch.softmax(filter_logits(logits.float(), temperature, top_k,
                                        top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
