"""Mixture-of-experts feed-forward (counterpart of
``blt_vqg_tpu/ops/moe.py``).

A drop-in for ``PositionwiseFeedForward``: a router in f32, top-k routing
with a static per-expert capacity, and the experts' FFNs as dense einsums
against one-hot dispatch and combine tensors, as the JAX package computes
them (outside any Pallas kernel, so these stay tensor products here).

What the JAX package does, and this module copies:

- tokens are the rows of x [B, T, D] flattened in row-major order, pad
  tokens included; a KV-cache decode step routes its B tokens, so its
  capacity is ``ceil(cf * k * B / E)``;
- the top k experts of a token in descending probability, ties to the
  lower expert (``jax.lax.top_k``'s order; a stable sort here, since
  ``torch.topk`` leaves the order of ties open); for k > 1 the gates are
  renormalized over the k chosen;
- slots are claimed in token order, every first choice before any second
  choice; an assignment past the capacity is dropped (the token's output
  from that expert is zero);
- the router noise (``router_noise``) is drawn in training only, from the
  dropout generator;
- ``combine`` is cast to the compute dtype before the last product, so
  each gate is rounded to bf16 when the model computes in bf16;
- the load-balance loss ``E * sum_e f_e p_e`` (f from first choices) and
  the router-z loss ``mean(logsumexp(logits)^2)``.  The JAX package sows
  them into a ``"moe"`` collection; here a forward given a list ``aux``
  appends ``(balance, router_z)`` to it (the train step averages them over
  layers, train/step.py).

The parameters keep the JAX names and layouts: ``router`` [D, E],
``expert_in`` [E, D, F], ``expert_in_bias`` [E, F], ``expert_out``
[E, F, D], ``expert_out_bias`` [E, D], all f32, cast to the compute dtype
at use.

Across processes (``parallel/sharding.py``): the tokens are this rank's
rows of the global batch, and the routing stays the single-process one,
replicated: the capacity counts the global tokens, a token's slot counts
the tokens of earlier batch shards before it (one all-reduce of the
per-expert counts), and the losses are means over the global tokens.
Under expert parallelism a rank holds ``E / expert`` experts
(``expert_split``), computes them over its tokens and the outputs are
summed over the ``expert`` axis; under tensor parallelism each expert's
FFN width is split over ``model`` as the dense FFN's is.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from blt_vqg_tpu_torch.ops.layers import activation_fn, dropout
from blt_vqg_tpu_torch.parallel import collectives as col

ROUTER_STD = 0.02


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-expert slot count: ceil(cf * k * S / E), clamped to
    [1, S]."""
    cap = int(-(-capacity_factor * top_k * num_tokens // num_experts))
    return max(1, min(cap, num_tokens))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, descending,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def _shard_counts(idx: torch.Tensor, e: int):
    """(before, total) [k, E]: per choice and expert, the tokens of the
    batch shards before this one, and of all shards, that made that
    choice (None, None outside a sharded step)."""
    group = col.batch_group()
    if group is None:
        return None, None
    index, count = col.current().batch_coord()
    mine = torch.stack([F.one_hot(idx[:, j], e).sum(dim=0)
                        for j in range(idx.shape[1])])          # [k, E]
    table = mine.new_zeros((count,) + mine.shape)
    table[index] = mine
    table = col.all_reduce(table, group)
    return table[:index].sum(dim=0), table.sum(dim=0)


def route_tokens(probs: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router probabilities probs [S, E] (f32) -> (dispatch, combine)
    [S, E, C]: the one-hot (expert, slot) assignments and the same scaled by
    each assignment's gate.  Slot j of expert e goes to the j-th token (in
    token order, all first choices before any second choice) that chose e;
    assignments past ``capacity`` are dropped (zero rows in both).  In a
    sharded step the order is that of the global tokens."""
    s, e = probs.shape
    gates, idx = top_k(probs, k)
    before, total = _shard_counts(idx, e)
    if k > 1:
        gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True),
                                        1e-9)
    dispatch = torch.zeros((s, e, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=torch.int64, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    for j in range(k):
        oh = F.one_hot(idx[:, j], e)                         # [S, E]
        pos = torch.cumsum(oh, dim=0) - oh + counts[None, :]
        if before is not None:
            pos = pos + before[j][None, :]
        pos_j = (pos * oh).sum(dim=-1)                       # [S]
        keep = (pos_j < capacity).to(probs.dtype)
        slot = (pos_j[:, None] == slots[None, :]).to(probs.dtype)  # [S, C]
        d_j = (oh.to(probs.dtype) * keep[:, None])[:, :, None] * slot[:, None]
        dispatch = dispatch + d_j
        combine = combine + d_j * gates[:, j][:, None, None]
        counts = counts + (oh.sum(dim=0) if total is None else total[j])
    return dispatch, combine


def balance_loss(probs: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss E * sum_e f_e * p_e: 1 at uniform routing;
    f from the first choices ``top1`` [S], p from the full softmax (means
    over the global tokens in a sharded step)."""
    e = probs.shape[-1]
    f = col.batch_mean(F.one_hot(top1, e).to(probs.dtype), dim=0)
    return e * torch.sum(f * col.batch_mean(probs, dim=0))


class MoEFeedForward(nn.Module):
    """Mixture-of-experts positionwise FFN; ``activation`` "relu" or "gelu"
    (flax's tanh approximation)."""

    def __init__(self, hidden_dim: int, pwffn_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dropout_rate: float = 0.1, dtype=torch.bfloat16,
                 activation: str = "relu", router_noise: float = 0.0):
        super().__init__()
        d, f, e = hidden_dim, pwffn_dim, num_experts
        self.router = nn.Parameter(torch.zeros(d, e))
        self.expert_in = nn.Parameter(torch.zeros(e, d, f))
        self.expert_in_bias = nn.Parameter(torch.zeros(e, f))
        self.expert_out = nn.Parameter(torch.zeros(e, f, d))
        self.expert_out_bias = nn.Parameter(torch.zeros(e, d))
        self.num_experts, self.top_k = e, top_k
        self.capacity_factor, self.dropout_rate = capacity_factor, dropout_rate
        self.compute_dtype, self.activation = dtype, activation
        self.router_noise = router_noise
        # (expert group, first local expert) and the model group, set by
        # parallel/sharding.py parallelize; None: every expert, whole
        self.expert_split: Optional[Tuple[object, int]] = None
        self.model_group = None

    @torch.no_grad()
    def seed_init(self, generator: torch.Generator) -> None:
        """Seed-made weights at the JAX initializers' scales: the router
        normal(0.02), each expert's kernels at variance 1 / fan_in, zero
        biases."""
        self.router.copy_(torch.randn(self.router.shape, generator=generator)
                          * ROUTER_STD)
        for w in (self.expert_in, self.expert_out):
            w.copy_(torch.randn(w.shape, generator=generator)
                    / math.sqrt(w.shape[1]))
        self.expert_in_bias.zero_()
        self.expert_out_bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                aux: Optional[list] = None) -> torch.Tensor:
        """x [..., D] -> [..., D].  ``generator`` draws the dropout and the
        router noise (train mode); ``aux``, a list, receives the layer's
        (balance, router_z) losses."""
        d, e = x.shape[-1], self.num_experts
        tokens = x.reshape(-1, d)
        logits = tokens.float() @ self.router.float()             # [S, E]
        if self.router_noise > 0.0 and generator is not None:
            logits = logits + self.router_noise * col.draw(
                torch.randn, logits.shape, generator, logits.device)
        probs = torch.softmax(logits, dim=-1)
        cap = expert_capacity(tokens.shape[0] * col.batch_count(), e,
                              self.top_k, self.capacity_factor)
        dispatch, combine = route_tokens(probs, self.top_k, cap)
        if aux is not None:
            aux.append((balance_loss(probs, torch.argmax(probs, dim=-1)),
                        col.batch_mean(torch.square(
                            torch.logsumexp(logits, dim=-1)))))

        dt = self.compute_dtype
        act = activation_fn(self.activation)
        b_in = self.expert_in_bias
        egroup = None
        if self.expert_split is not None:
            # this rank's experts; the others' gradients come back through
            # the sums over the expert axis
            egroup, e0 = self.expert_split
            el = self.expert_in.shape[0]
            dispatch = dispatch[:, e0:e0 + el]
            combine = col.slice_of(combine, egroup, 1)
            tokens = col.copy_to(tokens, egroup)
        xin = torch.einsum("sec,sd->ecd", dispatch.to(dt), tokens.to(dt))
        mgroup = self.model_group
        if mgroup is not None:
            xin = col.copy_to(xin, mgroup)
            b_in = col.slice_of(b_in, mgroup, 1)
        h = act(torch.einsum("ecd,edf->ecf", xin, self.expert_in.to(dt))
                + b_in[:, None, :].to(dt))
        h = dropout(h, self.dropout_rate, generator,
                    {0: "expert", 2: "model"})
        out = col.reduce_from(
            torch.einsum("ecf,efd->ecd", h, self.expert_out.to(dt)), mgroup)
        out = out + self.expert_out_bias[:, None, :].to(dt)
        y = col.reduce_from(torch.einsum("sec,ecd->sd", combine.to(dt), out),
                            egroup)
        return y.reshape(x.shape)
