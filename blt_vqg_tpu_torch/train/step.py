"""Train, eval and decode steps (counterpart of ``blt_vqg_tpu/train/step.py``),
and the synthetic batches of the JAX package's batch contract.

Batch contract (keys as in the JAX package):
  images    [B, H, W, 3] float32 (already augmented and normalised)
  context   [B, Tc] int — answer or category tokens per ``input_mode``
  posterior [B, Tp] int
  target    [B, Tq] int — the question

A train step is ``step(state, batch, generator) -> (state, metrics)``: the
forward in train mode (dropout and the posterior noise drawn from
``generator``, batch-norm statistics updated), the losses, the backward
over the trainable parameters, then ``FusedClipAdam``.  The metrics are the
JAX package's (``loss``, ``rec``, ``img``, ``ppl``, ``kld``, ``aux``,
``elbo``, ``grad_norm`` with ``log_grad_norm``, ``skipped_nonfinite`` with
``guard_nonfinite``), as device tensors: nothing waits for the card, except
``guard_nonfinite``, which reads the loss on the host to decide.  Not
ported (ROADMAP.md): MoE losses, ``make_multi_step`` and
``grad_dtype="bfloat16"``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.train.fused_adam import global_norm
from blt_vqg_tpu_torch.train.losses import compute_losses
from blt_vqg_tpu_torch.train.state import TrainState

NUM_CATEGORIES = 8   # synthetic categories map to word ids 6 + cat


def make_batch(cfg: Config, vocab_size: int, batch: int,
               rng: np.random.RandomState, device="cuda") -> Dict[str, torch.Tensor]:
    """A synthetic batch of the contract, from ``rng``.  Context is
    ``[<start>, category word, <end>]`` in "cat" mode, else random words.
    Posteriors and targets are random words followed by trailing pads, each
    row 8 to 20 tokens long (at most the sequence length), so no row is all
    pad and the key-pad masks are exercised."""
    s = cfg.image_size
    images = rng.rand(batch, s, s, 3).astype(np.float32)
    tc = cfg.max_context_len
    if cfg.input_mode == "cat":
        context = np.zeros((batch, tc), np.int64)
        context[:, 0] = 1
        context[:, 1] = 6 + rng.randint(0, NUM_CATEGORIES, batch)
        context[:, 2] = 3
    else:
        context = rng.randint(1, vocab_size, (batch, tc))

    def padded(t):
        tokens = rng.randint(1, vocab_size, (batch, t))
        lengths = rng.randint(min(8, t), min(20, t) + 1, batch)
        tokens[np.arange(t)[None, :] >= lengths[:, None]] = 0
        return tokens

    arrays = {"images": images, "context": context,
              "posterior": padded(cfg.max_posterior_len),
              "target": padded(cfg.max_q_length)}
    return {k: torch.from_numpy(v.astype(np.float32 if k == "images"
                                         else np.int32)).to(device)
            for k, v in arrays.items()}


def _losses(cfg: Config, state: TrainState, batch, outputs, latent_mode):
    logits, z_logit, kld, image_recon = outputs
    return compute_losses(
        logits, batch["target"], image_recon, kld, z_logit,
        kliter=state.kliter, latent_mode=latent_mode,
        kl_ceiling=cfg.kl_ceiling, aux_ceiling=cfg.aux_ceiling,
        image_recon_lambda=cfg.image_recon_lambda,
        full_kl_step=cfg.full_kl_step, kl_floor=cfg.kl_floor)


def _forward(state: TrainState, batch, latent_mode, train, generator, eps):
    return state.model(batch["images"], batch["context"], batch["posterior"],
                       batch["target"], latent_mode=latent_mode, train=train,
                       generator=generator, eps=eps)


def make_train_step(cfg: Config, latent_mode: bool, mesh=None) -> Callable:
    """``step(state, batch, generator, eps=None) -> (state, metrics)``; the
    state is updated in place.  ``eps`` injects the posterior noise
    [B, latent] in place of a draw from ``generator``.  ``mesh`` is taken
    for the JAX signature and unused: a sequence-parallel mesh goes with
    the model (``IQ(cfg, vocab, mesh)``)."""
    del mesh
    if cfg.grad_dtype != "float32":
        raise NotImplementedError(
            "grad_dtype='bfloat16' is not ported yet (ROADMAP.md)")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator,
             eps: Optional[torch.Tensor] = None):
        stats = None
        if cfg.guard_nonfinite:
            stats = {n: b.clone() for n, b in state.model.named_buffers()}
        out = _losses(cfg, state, batch,
                      _forward(state, batch, latent_mode, True, generator,
                               eps), latent_mode)
        params = state.trainable()
        grads = torch.autograd.grad(out.loss, list(params.values()),
                                    allow_unused=True)
        grads = dict(zip(params, grads))
        kliter_inc = 1 if latent_mode else 0
        metrics = {k: v.detach() for k, v in out.as_dict().items()}
        skipped = stats is not None and not bool(torch.isfinite(out.loss))
        if skipped:
            # keep the previous parameters, moments and statistics; the
            # step and kliter still advance
            with torch.no_grad():
                for n, b in state.model.named_buffers():
                    b.copy_(stats[n])
            gnorm = global_norm(grads, state.opt_state.mu)
            state.step += 1
            state.kliter += kliter_inc
        else:
            state, gnorm = state.apply_gradients_with_norm(grads, kliter_inc)
        if cfg.log_grad_norm:
            metrics["grad_norm"] = gnorm
        if stats is not None:
            metrics["skipped_nonfinite"] = torch.tensor(
                float(skipped), device=out.loss.device)
        return state, metrics

    return step


def make_eval_step(cfg: Config, latent_mode: bool, mesh=None) -> Callable:
    """Validation forward: ``step(state, batch, generator=None, eps=None)
    -> metrics``; the same losses, no gradient, batch statistics frozen.
    The posterior noise is ``eps`` or a draw from ``generator``; one of the
    two is required, so the metrics follow from the arguments.  In latent
    mode ``aux_acc`` is the share of rows whose z-head argmax is a
    (non-pad) word of the row's target.  ``mesh``: as in
    :func:`make_train_step`."""
    del mesh

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if generator is None and eps is None:
            raise ValueError("the eval step needs a generator or eps for "
                             "the posterior noise")
        with torch.no_grad():
            outputs = _forward(state, batch, latent_mode, False, generator,
                               eps)
            metrics = dict(_losses(cfg, state, batch, outputs,
                                   latent_mode).as_dict())
            z_logit = outputs[1]
            if latent_mode and z_logit is not None:
                za = torch.argmax(z_logit, dim=-1)
                target = batch["target"]
                hit = ((za[:, None] == target) & (target != 0)).any(dim=1)
                metrics["aux_acc"] = hit.float().mean()
        return metrics

    return step


def make_decode_step(cfg: Config, model, latent_mode: bool,
                     with_probe: bool = True) -> Callable:
    """Decode: ``step(images, context, generator=None,
    sample_generator=None) -> dict``.

    ``with_probe=False`` is the serving variant (no per-step top-6 probe).
    ``cfg.decode_early_stop``, ``cfg.decode_z_source`` and
    ``cfg.decode_sampling`` (with ``decode_temperature``, ``decode_top_k``
    and ``decode_top_p``) select the loop exit, the latent z and the token
    choice as in the JAX package.  ``generator`` supplies the prior
    sample's noise; sampled tokens come from ``sample_generator``, a stream
    of their own.  Runs under ``torch.inference_mode()``."""
    kwargs = dict(max_decode_length=cfg.max_decode_length,
                  latent_mode=latent_mode, with_probe=with_probe,
                  early_stop=cfg.decode_early_stop,
                  z_source=cfg.decode_z_source)
    if cfg.decode_sampling:
        kwargs.update(sample=True, temperature=cfg.decode_temperature,
                      top_k=cfg.decode_top_k, top_p=cfg.decode_top_p)

    def step(images: torch.Tensor, context: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sample_generator: Optional[torch.Generator] = None) -> dict:
        with torch.inference_mode():
            return model.decode_greedy(images, context, generator=generator,
                                       sample_generator=sample_generator,
                                       **kwargs)

    return step


def make_diag_decode_step(cfg: Config, model, z_source: str) -> Callable:
    """Latent-mode greedy decode with an explicit z source, the
    posterior-vs-prior decode gap instrument: ``step(images, context,
    posterior, generator=None) -> {"tokens": [B, L]}``; ``posterior`` is
    ignored by the prior sources."""
    uses_post = z_source.startswith("posterior")

    def step(images: torch.Tensor, context: torch.Tensor, posterior,
             generator: Optional[torch.Generator] = None) -> dict:
        with torch.inference_mode():
            return model.decode_greedy(
                images, context, cfg.max_decode_length, latent_mode=True,
                with_probe=False, z_source=z_source,
                posterior=posterior if uses_post else None,
                generator=generator)

    return step


def make_beam_decode_step(cfg: Config, model, latent_mode: bool) -> Callable:
    """Beam-search decode with ``cfg.beam_size`` beams: ``step(images,
    context, generator=None) -> dict`` with ``tokens`` [B, L] (the best
    beam) and ``scores`` [B]; ``generator`` supplies the prior sample's
    noise."""

    def step(images: torch.Tensor, context: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> dict:
        with torch.inference_mode():
            return model.decode_beam(
                images, context, beam_size=cfg.beam_size,
                max_decode_length=cfg.max_decode_length,
                latent_mode=latent_mode, generator=generator)

    return step
