"""Multi-head attention (counterpart of ``blt_vqg_tpu/ops/attention.py``).

Products run in ``dtype``, logits and softmax in f32, masked logits take the
finite ``MASK_FILL``.  The q/k/v/out projections have no biases.  The decode
path keeps explicit KV caches [B, L, H, Dh]; unlike the JAX package, which
returns updated arrays, :meth:`MultiHeadAttention.step` writes the caches
in place and returns them.

Full attention takes the JAX module's gates.  With a ``ring_mesh`` whose
``seq`` axis has n > 1 ranks, self-attention (Tq == Tk) whose length n
divides, under a key-padding mask (or none) and no active attention
dropout, runs as ring attention (``ops/ring_attention.py``, ``ring_impl``
"xla" or "pallas"); that gate comes first.  Otherwise, with ``use_pallas``,
the same mask and dropout conditions take the flash-attention kernel
(``ops/kernels/flash_attention.py``).  Otherwise the einsum path runs,
whose softmax weights take attention dropout from an explicit
``torch.Generator`` (no generator means deterministic).

Under tensor parallelism (``parallel/sharding.py`` ``parallelize``) the
q/k/v projections hold this rank's heads and ``out_proj`` the matching
input rows: ``num_heads`` is then the local head count, every path above
runs on those heads as plain local tensors (the flash kernels included),
and ``out_proj`` sums the ranks' partial outputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from blt_vqg_tpu_torch.ops.kernels.flash_attention import flash_attention
from blt_vqg_tpu_torch.ops.layers import Dense, dropout
from blt_vqg_tpu_torch.ops.masks import FUTURE_FILL, MASK_FILL, causal_mask
from blt_vqg_tpu_torch.ops.ring_attention import ring_attention
from blt_vqg_tpu_torch.parallel.mesh import SEQ


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of ``dtype`` operands with f32 accumulation: the products of
    two bf16 values are exact in f32, so upcasting first is the same
    arithmetic as an f32-accumulating bf16 product."""
    return torch.einsum(eq, a.float(), b.float())


class MultiHeadAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, dtype=torch.bfloat16,
                 causal: bool = False, use_pallas: bool = False,
                 ring_mesh=None, dropout_rate: float = 0.1,
                 ring_impl: str = "xla"):
        super().__init__()
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.head_dim = hidden_dim // num_heads
        self.dtype, self.causal = dtype, causal
        self.use_pallas, self.dropout_rate = use_pallas, dropout_rate
        self.ring_mesh, self.ring_impl = ring_mesh, ring_impl
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(hidden_dim, hidden_dim, bias=False,
                                        dtype=dtype))

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, -1, self.head_dim)

    def _attend(self, q, k, v, mask, tq, generator=None):
        logits = _f32_einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(mask, MASK_FILL)
        weights = torch.softmax(logits, dim=-1).to(self.dtype)
        weights = dropout(weights, self.dropout_rate, generator,
                          {0: "batch", 1: "model"})
        ctx = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(self.dtype))
        return self.out_proj(ctx.reshape(q.shape[0], tq, -1))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full attention. q_in [B,Tq,D], kv_in [B,Tk,D]; ``mask`` is a
        key-padding mask [B|1, 1, 1, Tk] (True = masked); ``generator``
        draws the attention dropout (None: deterministic).  When ``causal``
        the j > i constraint is added: structurally on the flash path, as
        an OR-ed mask on the einsum path."""
        q = self._split(self.q_proj(q_in)) * (self.head_dim ** -0.5)
        k = self._split(self.k_proj(kv_in))
        v = self._split(self.v_proj(kv_in))
        b, tq, tk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
        key_pad_only = mask is None or mask.shape[2] == 1
        no_dropout = self.dropout_rate == 0.0 or generator is None
        kv_pad = None if mask is None else mask[:, 0, 0, :].expand(b, tk)
        ring_n = (self.ring_mesh.shape.get(SEQ, 1)
                  if self.ring_mesh is not None else 1)
        if (ring_n > 1 and tq == tk and tq % ring_n == 0 and key_pad_only
                and no_dropout):
            names = self.ring_mesh.shape
            ctx = ring_attention(
                q, k, v, self.ring_mesh, axis=SEQ,
                causal=self.causal, kv_pad=kv_pad,
                batch_axis=("data" if "data" in names
                            and b % names["data"] == 0 else None),
                head_axis=("model" if "model" in names
                           and self.num_heads % names["model"] == 0
                           else None),
                impl=self.ring_impl)
            return self.out_proj(ctx.reshape(b, tq, -1))
        if self.use_pallas and key_pad_only and no_dropout:
            ctx = flash_attention(q, k, v, kv_pad, causal=self.causal)
            return self.out_proj(ctx.reshape(b, tq, -1))
        if self.causal:
            cm = causal_mask(tk, q_in.device)[:, :, :tq]
            mask = cm if mask is None else (mask | cm)
        return self._attend(q, k, v, mask, tq, generator)

    # ---- decode path: explicit KV cache ----

    def kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Precomputed K/V ([B,Tk,H,Dh] each) for cross-attention."""
        return self._split(self.k_proj(kv_in)), self._split(self.v_proj(kv_in))

    def attend_cached(self, q_in: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention against precomputed K/V. q_in [B,Tq,D]."""
        q = self._split(self.q_proj(q_in)) * (self.head_dim ** -0.5)
        return self._attend(q, k, v, mask, q_in.shape[1])

    def step(self, q_in: torch.Tensor, cache_k: torch.Tensor,
             cache_v: torch.Tensor, pos: int,
             key_pad: Optional[torch.Tensor] = None):
        """One self-attention decode step at position ``pos``.

        q_in [B,1,D].  Its K/V are written into the caches [B,L,H,Dh] at
        ``pos`` in place; attention spans positions <= pos.  ``key_pad``
        [B, L] bool also masks keys whose token was <pad>; its fill sits
        above the future fill, so an all-pad visible prefix comes out
        uniform over the visible keys.  Returns (out [B,1,D], cache_k,
        cache_v).  Q/K/V come from one fused [D, 3D] product.
        """
        w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                       self.v_proj.weight], dim=0).to(self.dtype)
        qkv = q_in.to(self.dtype) @ w.T                       # [B,1,3D]
        q_f, k_f, v_f = qkv.split(self.hidden_dim, dim=-1)
        cache_k[:, pos] = self._split(k_f)[:, 0]
        cache_v[:, pos] = self._split(v_f)[:, 0]

        q = self._split(q_f) * (self.head_dim ** -0.5)
        logits = _f32_einsum("bqhd,bkhd->bhqk", q, cache_k)
        l = cache_k.shape[1]
        future = torch.arange(l, device=q_in.device) > pos
        logits = logits.masked_fill(future, FUTURE_FILL)
        if key_pad is not None:
            logits = logits.masked_fill(key_pad[:, None, None, :], MASK_FILL)
        weights = torch.softmax(logits, dim=-1).to(self.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", weights, cache_v)
        out = self.out_proj(ctx.reshape(q_in.shape[0], 1, self.hidden_dim))
        return out, cache_k, cache_v
