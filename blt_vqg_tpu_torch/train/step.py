"""Decode step factory (counterpart of ``make_decode_step`` in
``blt_vqg_tpu/train/step.py``).  The train steps are not ported yet
(ROADMAP.md queue 1)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from blt_vqg_tpu_torch.core.config import Config


def make_decode_step(cfg: Config, model, latent_mode: bool,
                     with_probe: bool = True) -> Callable:
    """Greedy decode: ``step(images, context, generator=None) -> dict``.

    ``with_probe=False`` is the serving variant (no per-step top-6 probe).
    ``cfg.decode_early_stop`` and ``cfg.decode_z_source`` select the loop
    exit and the latent z as in the JAX package; ``generator`` supplies the
    prior sample's noise.  Runs under ``torch.inference_mode()``."""
    if cfg.decode_sampling:
        raise NotImplementedError(
            "sampled decoding is not ported yet (ROADMAP.md queue 1)")
    kwargs = dict(max_decode_length=cfg.max_decode_length,
                  latent_mode=latent_mode, with_probe=with_probe,
                  early_stop=cfg.decode_early_stop,
                  z_source=cfg.decode_z_source)

    def step(images: torch.Tensor, context: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> dict:
        with torch.inference_mode():
            return model.decode_greedy(images, context, generator=generator,
                                       **kwargs)

    return step
