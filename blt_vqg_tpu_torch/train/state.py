"""Train state (counterpart of ``blt_vqg_tpu/train/state.py``): the model
(parameters and batch-norm statistics), the optimizer state, the global step
and the KL-anneal counter ``kliter``.

The optimizer is ``FusedClipAdam`` (global-norm clip ``cfg.grad_clip``,
Adam) on the Noam schedule, whose learning rate is read at the global step
*before* it increments, so the Adam restart at the phase boundary
(:meth:`TrainState.reset_optimizer`) resets the moments while the learning
rate keeps its global clock.  The ResNet backbone is frozen: it carries no
moments and builds no gradient (its parameters have ``requires_grad``
off), though its batch-norm statistics still update in train mode.

Unlike the JAX package's immutable state, this one is updated in place: a
train step changes the model's parameters and statistics and returns the
same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.train.fused_adam import FusedAdamState, FusedClipAdam
from blt_vqg_tpu_torch.train.schedule import noam_schedule

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def is_frozen(name: str) -> bool:
    """The CNN backbone is frozen; only its fc head and feature BN train."""
    return name.startswith("encoder_cnn.backbone.")


def is_f32_consumed(name: str) -> bool:
    """The vocab heads compute in f32, so they keep f32 storage under
    ``param_dtype="bfloat16"``."""
    return name.startswith(("output_proj.", "z_classifier."))


def make_optimizer(cfg: Config) -> FusedClipAdam:
    if not cfg.fused_adam:
        raise NotImplementedError(
            "the unfused optax chain (fused_adam=False) is not ported; the "
            "fused update computes the same numbers")
    mixed = cfg.param_dtype == "bfloat16"
    return FusedClipAdam(
        cfg.grad_clip, is_frozen, mu_dtype=_DTYPES[cfg.adam_mu_dtype],
        master_fn=(lambda n: not is_f32_consumed(n)) if mixed else None,
        factored_nu=cfg.adam_factored_nu)


@dataclass
class TrainState:
    step: int
    kliter: int
    model: torch.nn.Module
    opt_state: FusedAdamState
    tx: FusedClipAdam
    lr_fn: Callable[[int], float]

    def trainable(self) -> Dict[str, torch.nn.Parameter]:
        """The parameters the optimizer updates, by ``state_dict`` name."""
        return {n: p for n, p in self.model.named_parameters()
                if not is_frozen(n)}

    def apply_gradients_with_norm(self, grads: Dict[str, torch.Tensor],
                                  kliter_inc: int = 0):
        """One optimizer update from ``grads`` (by name; missing = zero);
        returns (self, the global gradient norm)."""
        lr = self.lr_fn(self.step)
        self.opt_state, gnorm = self.tx.update_params(
            self.trainable(), grads, self.opt_state, lr)
        self.step += 1
        self.kliter += kliter_inc
        return self, gnorm

    def reset_optimizer(self) -> "TrainState":
        """Adam restart at the pretrain -> latent boundary; f32 masters
        survive it (only the moments reset)."""
        new = self.tx.init(dict(self.model.named_parameters()))
        self.opt_state = new._replace(master=self.opt_state.master)
        return self


def create_train_state(cfg: Config, model: torch.nn.Module,
                       seed: Optional[int] = 0) -> TrainState:
    """The train state of ``model`` (already on its device).  With ``seed``
    the weights are made from it first; with None the model's own weights
    (for example loaded from a JAX checkpoint) are kept."""
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(seed))
    for name, p in model.named_parameters():
        p.requires_grad_(not is_frozen(name))
    tx = make_optimizer(cfg)
    params = dict(model.named_parameters())
    opt_state = tx.init(params)   # masters snapshot the f32 parameters
    tx.cast_params(params)
    return TrainState(step=0, kliter=0, model=model, opt_state=opt_state,
                      tx=tx, lr_fn=noam_schedule(cfg.hidden_dim,
                                                 cfg.warmup_steps))
