"""Named, per-step random streams (counterpart of ``blt_vqg_tpu/core/rng.py``).

Every random draw of the trainer takes an explicit ``torch.Generator``
whose seed depends only on (root seed, step, name): no Python-side state,
so a resumed run draws the same numbers as the run it resumes.  Names hash
with FNV-1a (``_stable_hash``), as in the JAX package, because Python's
``hash()`` is salted per process.  The seeds are mixed with splitmix64;
they are not the JAX package's ``fold_in`` keys, so the two packages draw
different numbers for the same (seed, step, name).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finalizer: a bijection on 64-bit ints."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _stable_hash(name: str) -> int:
    # Python's hash() is salted per-process; use a stable FNV-1a instead so
    # resumed runs derive identical keys.
    h = 0x811C9DC5
    for b in name.encode():
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


class RngStream:
    """Deterministically derives named per-step generators from one root
    seed: ``RngStream(seed).key(step, device)`` is the generator of a step,
    ``step_keys(step, "dropout", "latent", device=...)`` independent ones
    by name."""

    def __init__(self, seed: int):
        self.root = int(seed)

    def seed(self, step: int, name: Optional[str] = None) -> int:
        """The 63-bit seed of (root, step[, name])."""
        s = _mix(_mix(self.root & _MASK64) ^ (int(step) & _MASK64))
        if name is not None:
            s = _mix(s ^ _stable_hash(name))
        return s >> 1

    def key(self, step: int, device="cpu") -> torch.Generator:
        return torch.Generator(device).manual_seed(self.seed(step))

    def step_keys(self, step: int, *names: str,
                  device="cpu") -> Dict[str, torch.Generator]:
        return {name: torch.Generator(device).manual_seed(
            self.seed(step, name)) for name in names}
