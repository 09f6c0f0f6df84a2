"""Sinusoidal timing signal (counterpart of ``blt_vqg_tpu/ops/timing.py``).

Sin over the first half of the channels and cos over the second,
concatenated, not interleaved.
"""

from __future__ import annotations

import math

import torch


def timing_signal(length: int, channels: int,
                  min_timescale: float = 1.0,
                  max_timescale: float = 1.0e4,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Returns [1, length, channels]."""
    position = torch.arange(length, dtype=torch.float32, device=device)
    num_timescales = channels // 2
    log_timescale_increment = (
        math.log(max_timescale / min_timescale) / max(num_timescales - 1, 1))
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_timescale_increment)
    scaled_time = position[:, None] * inv_timescales[None, :]
    signal = torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)], dim=1)
    if channels % 2:
        signal = torch.nn.functional.pad(signal, (0, 1))
    return signal[None].to(dtype)
