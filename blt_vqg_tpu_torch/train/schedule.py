"""Learning-rate schedule (counterpart of ``blt_vqg_tpu/train/schedule.py``):
the Noam curve

    lr(step) = sqrt(1/hidden_dim) * min(sqrt(1/(step+1)), step * warmup^-1.5)

computed in f32, as the JAX package's schedule computes it, and
``ReduceLROnPlateau``, the metric-driven decay of the legacy loop (a
multiplier on top of the base learning rate, as in the JAX package).
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


class ReduceLROnPlateau:
    """Metric-driven LR decay — the legacy manual loop's scheduler
    (reference old_train_iq.py:360-362: torch ReduceLROnPlateau(mode='min',
    factor=0.1, patience, min_lr=1e-7)).

    Functional: ``update(metric) -> lr_scale`` returns the multiplier to
    apply on top of the base schedule/LR; the caller owns the optimizer
    (jit-friendly — scale is a host-side float fed as a step argument,
    like the Noam poke).

    Floor semantics: torch's ``min_lr`` floors the ABSOLUTE learning rate;
    since this class returns a relative multiplier, pass ``base_lr`` to get
    the same behavior (the returned scale is floored at ``min_lr/base_lr``).
    Without ``base_lr`` the floor applies to the multiplier itself —
    equivalent only when the base LR is 1.0.
    """

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 min_lr: float = 1e-7, min_delta: float = 0.0,
                 base_lr: float = None):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_lr / base_lr if base_lr else min_lr
        self.min_delta = min_delta
        self.best = float("inf")
        self.bad = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        m = float(metric)
        if m < self.best - self.min_delta:
            self.best = m
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad = 0
        return self.scale
