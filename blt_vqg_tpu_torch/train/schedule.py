"""Learning-rate schedule (counterpart of ``blt_vqg_tpu/train/schedule.py``):
the Noam curve

    lr(step) = sqrt(1/hidden_dim) * min(sqrt(1/(step+1)), step * warmup^-1.5)

computed in f32, as the JAX package's schedule computes it.  The trainer's
``ReduceLROnPlateau`` is not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch


def noam_schedule(hidden_dim: int, warmup_steps: int = 4000):
    """``schedule(step) -> lr``, a Python float holding the f32 value."""
    scale = (1.0 / hidden_dim) ** 0.5
    wu = float(warmup_steps) ** -1.5

    def schedule(step: int) -> float:
        s = torch.tensor(float(step), dtype=torch.float32)
        return float(scale * torch.minimum(torch.sqrt(1.0 / (s + 1.0)),
                                           s * wu))

    return schedule
