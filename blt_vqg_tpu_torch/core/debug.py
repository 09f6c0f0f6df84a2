"""Numerical-hazard guard (counterpart of ``blt_vqg_tpu/core/debug.py``).

:func:`enable_nan_checks` turns on ``torch.autograd.set_detect_anomaly``:
a backward that produces NaN raises at the forward operation that made it
(the JAX package flips ``jax_debug_nans``).  The train step's guard against
a non-finite update is ``cfg.guard_nonfinite`` in ``train/step.py``.
"""

from __future__ import annotations

import torch


def enable_nan_checks(enabled: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)
