"""Attention masks (counterpart of ``blt_vqg_tpu/ops/masks.py``).

Boolean masks are True where attention is forbidden.  They are applied to
f32 logits as a finite ``MASK_FILL`` (not ``-inf``), so a row whose keys are
all masked stays finite and comes out uniform.
"""

from __future__ import annotations

import torch

MASK_FILL = -1e18
# fill of cache slots past the decode position: strictly below MASK_FILL, so
# a visible prefix whose keys are all pad-masked still comes out uniform
FUTURE_FILL = 1e3 * MASK_FILL


def pad_mask(tokens: torch.Tensor, pad_idx: int = 0) -> torch.Tensor:
    """[B, T] int tokens -> [B, 1, 1, T] bool, True at padding positions."""
    return (tokens == pad_idx)[:, None, None, :]


def causal_mask(length: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] bool, True strictly above the diagonal (future)."""
    upper = torch.ones((length, length), dtype=torch.bool,
                       device=device).triu(1)
    return upper[None, None]


def decoder_mask(target_tokens: torch.Tensor,
                 pad_idx: int = 0) -> torch.Tensor:
    """[B, 1, T, T] bool: position (i, j) masked where j > i or token j is
    padding (the causal and key-padding masks combined)."""
    t = target_tokens.shape[1]
    return pad_mask(target_tokens, pad_idx) | causal_mask(
        t, target_tokens.device)


def apply_mask(logits: torch.Tensor, mask) -> torch.Tensor:
    """``logits`` with ``MASK_FILL`` where ``mask`` is True (None: as
    is)."""
    if mask is None:
        return logits
    return torch.where(mask, torch.tensor(MASK_FILL, dtype=logits.dtype,
                                          device=logits.device), logits)
