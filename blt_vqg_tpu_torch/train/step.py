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
over the trainable parameters (cast to bf16 under
``grad_dtype="bfloat16"``, before the norm and the update, as the JAX
package casts its gradient tree), then ``FusedClipAdam``.  With MoE FFNs
(``moe_num_experts`` > 1) the loss adds ``moe_aux_weight`` times the mean
balance loss and ``moe_router_z_weight`` times the mean router-z loss over
the MoE layers (the JAX ``_collect_moe_losses``).  The metrics are the JAX
package's (``loss``, ``rec``, ``img``, ``ppl``, ``kld``, ``aux``, ``elbo``,
``moe_balance`` and ``moe_router_z`` with MoE, ``grad_norm`` with
``log_grad_norm``, ``skipped_nonfinite`` with ``guard_nonfinite``), as
device tensors: nothing waits for the card, except ``guard_nonfinite``,
which selects the state on the device and then reads its flag back for
the Adam count (a host int).  :func:`make_multi_step` runs G
such steps in one call, on batches stacked on a leading axis, as eager
steps (the JAX package scans them in one program).

On a mesh across processes (``parallel/mesh.py``) each rank's batch is its
rows of the global batch, and a step is the single-process step over the
global batch: the model runs its split forms (``parallel/sharding.py``),
every random draw is the global one cut to the rank's rows
(``parallel/collectives.py``), every loss is normalised over the global
batch, and the gradients are summed over the batch axes (one all-reduce)
before the norm and the update, which the state's placement shares out
(ZeRO-1, FSDP).  On a ``seq`` axis the ranks of the ring run the step
alike and attention over their shards (``ops/ring_attention.py``); on a
``pipe`` axis the decoder's layers run as a pipeline
(``parallel/pipeline.py``) and their gradients are summed over ``pipe``.
The metrics are the global values on every rank, so ``guard_nonfinite``
decides alike everywhere.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, Optional

import numpy as np
import torch

from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.core.debug import guarded_update
from blt_vqg_tpu_torch.parallel import collectives as col
from blt_vqg_tpu_torch.parallel.mesh import BATCH_AXES, PIPE
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


def _forward(state: TrainState, batch, latent_mode, train, generator, eps,
             **kw):
    return state.model(batch["images"], batch["context"], batch["posterior"],
                       batch["target"], latent_mode=latent_mode, train=train,
                       generator=generator, eps=eps, **kw)


def collect_moe_losses(losses: list, device):
    """(balance, router_z): the means over the MoE layers of their
    losses (zeros when there are none)."""
    if not losses:
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return zero, zero
    n = len(losses)
    return (sum(b.float() for b, _ in losses) / n,
            sum(z.float() for _, z in losses) / n)


def _sharded(mesh):
    """The mesh a step runs sharded over, or None (one process; a
    sequence-parallel mesh goes with the model, ``IQ(cfg, vocab, mesh)``)."""
    return mesh if mesh is not None and mesh.across_processes else None


def _unsharded(state):
    pl = state.placement
    return contextlib.nullcontext() if pl is None else pl.unsharded(
        state.model)


# the parameters of the pipelined stack (ops/transformer.py _pipelined)
STAGED = "decoder.layer_"


def _all_reduce_by_dtype(grads: list, idx: list, group) -> list:
    """``grads`` with the entries ``idx`` summed over ``group``, in one
    all-reduce per dtype (an absent gradient as zeros)."""
    out = list(grads)
    by_dtype: Dict = {}
    for i in idx:
        by_dtype.setdefault(grads[i].dtype, []).append(i)
    for ids in by_dtype.values():
        flat = col.all_reduce(torch.cat([grads[i].reshape(-1) for i in ids]),
                              group)
        for i, part in zip(ids, flat.split([grads[i].numel() for i in ids])):
            out[i] = part.view_as(grads[i])
    return out


def reduce_gradients(grads: list, mesh, params: Dict) -> list:
    """The gradients of ``params`` (by name, in order) summed over the
    mesh's batch axes, in one all-reduce per dtype (the single-process
    gradient of the global loss).  On a mesh with a ``pipe`` axis the
    pipelined decoder layers' gradients, which are non-zero on their own
    stage only (absent on the others), are summed over ``pipe`` too."""
    group = mesh.group(PIPE)
    if group is not None:
        staged = [i for i, n in enumerate(params) if n.startswith(STAGED)]
        grads = [torch.zeros_like(p) if g is None and i in staged else g
                 for i, (g, p) in enumerate(zip(grads, params.values()))]
        grads = _all_reduce_by_dtype(grads, staged, group)
    group = mesh.group(*BATCH_AXES)
    if group is None:
        return grads
    return _all_reduce_by_dtype(grads, [i for i, g in enumerate(grads)
                                        if g is not None], group)


def _guarded_apply(state, grads, kliter_inc, stats, loss, metrics):
    """The update, then every parameter, moment, master and batch
    statistic selected on the device between the new and the previous
    value by whether the loss is finite (``core/debug.py``
    ``guarded_update``); the step and kliter advance either way.  The Adam
    count is a host int, like the step: ``guarded_update`` reads the flag
    back for it once the step is enqueued."""
    params = state.trainable()
    old = {"params": {n: p.detach().clone() for n, p in params.items()},
           "buffers": stats, "opt": state.opt_state}
    state, gnorm = state.apply_gradients_with_norm(grads, kliter_inc)
    new = {"params": {n: p.detach() for n, p in params.items()},
           "buffers": dict(state.model.named_buffers()),
           "opt": state.opt_state}
    picked, flags = guarded_update(old, new, {"loss": loss.detach()})
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(picked["params"][n])
        for n, b in new["buffers"].items():
            b.copy_(picked["buffers"][n])
    state.opt_state = picked["opt"]
    return state, gnorm, dict(metrics, skipped_nonfinite=flags[
        "skipped_nonfinite"])


def make_train_step(cfg: Config, latent_mode: bool, mesh=None) -> Callable:
    """``step(state, batch, generator, eps=None) -> (state, metrics)``; the
    state is updated in place.  ``eps`` injects the posterior noise
    [B, latent] (this rank's rows) in place of a draw from ``generator``.
    On a ``mesh`` across processes the step is sharded (module
    docstring)."""
    mesh = _sharded(mesh)
    moe = cfg.moe_num_experts > 1
    grad_dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg.grad_dtype]

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator,
             eps: Optional[torch.Tensor] = None):
        with col.active(mesh), _unsharded(state):
            return one_step(state, batch, generator, eps)

    def one_step(state, batch, generator, eps):
        stats = None
        if cfg.guard_nonfinite:
            stats = {n: b.clone() for n, b in state.model.named_buffers()}
        moe_losses = [] if moe else None
        out = _losses(cfg, state, batch,
                      _forward(state, batch, latent_mode, True, generator,
                               eps, moe_losses=moe_losses), latent_mode)
        metrics = {k: v.detach() for k, v in out.as_dict().items()}
        loss = out.loss
        if moe:
            balance, router_z = collect_moe_losses(moe_losses, loss.device)
            loss = (loss + cfg.moe_aux_weight * balance
                    + cfg.moe_router_z_weight * router_z)
            metrics.update(moe_balance=balance.detach(),
                           moe_router_z=router_z.detach(), loss=loss.detach())
        params = state.trainable()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        if mesh is not None:
            grads = reduce_gradients(grads, mesh, params)
        if grad_dtype is not None:
            # bf16 gradient storage: the norm and the update read the bf16
            # values; the optimizer promotes them back to f32
            grads = [None if g is None else g.to(grad_dtype) for g in grads]
        grads = dict(zip(params, grads))
        kliter_inc = 1 if latent_mode else 0
        if stats is None:
            state, gnorm = state.apply_gradients_with_norm(grads, kliter_inc)
        else:
            state, gnorm, metrics = _guarded_apply(state, grads, kliter_inc,
                                                   stats, loss, metrics)
        if cfg.log_grad_norm:
            metrics["grad_norm"] = gnorm
        return state, metrics

    return step


def make_multi_step(cfg: Config, latent_mode: bool, mesh=None) -> Callable:
    """G train steps in one call: ``multi(state, batches, generator_of)``,
    ``batches`` the single step's batch dict with a leading [G, ...] axis,
    ``generator_of(i)`` the generator of the call's step i.  Step i takes
    ``batches[k][i]`` and ``generator_of(i)``, so G multi steps equal G
    single steps on those generators.  Returns (the state, the last step's
    metrics), as the JAX package's scan does.  ``mesh``: as in
    :func:`make_train_step`."""
    step = make_train_step(cfg, latent_mode, mesh)

    def multi(state: TrainState, batches: Dict[str, torch.Tensor],
              generator_of: Callable[[int], torch.Generator]):
        metrics = None
        for i in range(next(iter(batches.values())).shape[0]):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()},
                                  generator_of(i))
        return state, metrics

    return multi


def make_eval_step(cfg: Config, latent_mode: bool, mesh=None) -> Callable:
    """Validation forward: ``step(state, batch, generator=None, eps=None)
    -> metrics``; the same losses, no gradient, batch statistics frozen.
    The posterior noise is ``eps`` or a draw from ``generator``; one of the
    two is required, so the metrics follow from the arguments.  In latent
    mode ``aux_acc`` is the share of rows whose z-head argmax is a
    (non-pad) word of the row's target.  ``mesh``: as in
    :func:`make_train_step` (the metrics are the global batch's)."""
    mesh = _sharded(mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if generator is None and eps is None:
            raise ValueError("the eval step needs a generator or eps for "
                             "the posterior noise")
        with torch.no_grad(), col.active(mesh), _unsharded(state):
            outputs = _forward(state, batch, latent_mode, False, generator,
                               eps)
            metrics = dict(_losses(cfg, state, batch, outputs,
                                   latent_mode).as_dict())
            z_logit = outputs[1]
            if latent_mode and z_logit is not None:
                za = torch.argmax(z_logit, dim=-1)
                target = batch["target"]
                hit = ((za[:, None] == target) & (target != 0)).any(dim=1)
                metrics["aux_acc"] = col.batch_mean(hit.float())
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
    of their own.  As in the JAX package, the model's ``decode_greedy`` is
    given only the keywords it takes (IQRNN's takes no probe, z source or
    sampling).  Runs under ``torch.inference_mode()``."""
    kwargs = dict(max_decode_length=cfg.max_decode_length,
                  latent_mode=latent_mode, with_probe=with_probe,
                  early_stop=cfg.decode_early_stop,
                  z_source=cfg.decode_z_source)
    if cfg.decode_sampling:
        kwargs.update(sample=True, temperature=cfg.decode_temperature,
                      top_k=cfg.decode_top_k, top_p=cfg.decode_top_p)
    takes = inspect.signature(type(model).decode_greedy).parameters
    kwargs = {k: v for k, v in kwargs.items() if k in takes}
    with_sampling = "sample_generator" in takes

    def step(images: torch.Tensor, context: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sample_generator: Optional[torch.Generator] = None) -> dict:
        extra = ({"sample_generator": sample_generator} if with_sampling
                 else {})
        with torch.inference_mode():
            return model.decode_greedy(images, context, generator=generator,
                                       **extra, **kwargs)

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


def make_latent_diag_step(cfg: Config, model) -> Callable:
    """The latent's distribution diagnostics (:meth:`IQ.latent_diagnostics`):
    ``step(images, context, posterior) -> dict``, under
    ``torch.inference_mode()``."""
    del cfg

    def step(images: torch.Tensor, context: torch.Tensor,
             posterior: torch.Tensor) -> dict:
        with torch.inference_mode():
            return model.latent_diagnostics(images, context, posterior)

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
