"""Numerical-hazard guards (counterpart of ``blt_vqg_tpu/core/debug.py``).

- :func:`enable_nan_checks` turns on ``torch.autograd.set_detect_anomaly``:
  a backward that produces NaN raises at the forward operation that made
  it (the JAX package flips ``jax_debug_nans``).
- :func:`guarded_update` keeps the previous state where this step's loss is
  not finite, selected on the device (``torch.where``), so nothing waits
  for the card; ``train/step.py`` guards its update with it under
  ``cfg.guard_nonfinite``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def enable_nan_checks(enabled: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def is_finite_tree(tree) -> torch.Tensor:
    """A bool tensor: every floating leaf of ``tree`` (tensors in nested
    dicts, lists and tuples) is finite."""
    ok = torch.tensor(True)
    for leaf in _leaves(tree):
        if leaf.is_floating_point():
            ok = ok.to(leaf.device) & torch.all(torch.isfinite(leaf))
    return ok


def _select(ok, new, old):
    """``new`` where ``ok`` else ``old``, leaf by leaf: tensors on the
    device, other leaves (host ints) from ``ok`` read back."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, dict):
        return {k: _select(ok, v, old[k]) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        picked = [_select(ok, a, b) for a, b in zip(new, old)]
        return type(new)(*picked) if hasattr(new, "_fields") else type(new)(
            picked)
    return new if bool(ok) else old


def guarded_update(old_state, new_state, metrics: Dict[str, torch.Tensor]
                   ) -> Tuple[object, Dict[str, torch.Tensor]]:
    """``new_state`` where ``metrics["loss"]`` is finite, else
    ``old_state``, leaf by leaf (trees of dicts, lists, tuples and named
    tuples: tensors are selected on the device, a host value such as the
    Adam count from the flag read back); ``metrics`` gains
    ``skipped_nonfinite``, 1.0 where the old state was kept."""
    ok = torch.isfinite(metrics["loss"])
    picked = _select(ok, new_state, old_state)
    metrics = dict(metrics)
    metrics["skipped_nonfinite"] = torch.logical_not(ok).float()
    return picked, metrics
