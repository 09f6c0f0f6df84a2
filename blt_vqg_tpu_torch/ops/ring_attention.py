"""Ring attention: sequence-parallel attention over the ``seq`` axis of a
mesh (counterpart of ``blt_vqg_tpu/ops/ring_attention.py``).

The sequence is cut into n equal shards, one per rank of the ring.  Each
rank keeps its query shard and the key/value shards visit it one hop at a
time, combined by an online softmax (running max, denominator and
accumulator in f32); the [T, T] score matrix never exists.  The ring is the
mesh's (``parallel/mesh.py``): on a mesh of one process its ranks are
shards on one device (``LocalRing``); on a mesh across processes each
process is one rank (``ProcessRing``), takes its own shard of the
sequence (whose gradient is summed over the ring) and gathers the ranks'
outputs (whose gradient keeps its own shard), since the layers around
attention run alike on every rank of the ring, as JAX's ``shard_map`` of
a replicated input does.  Batch and heads keep their ``data`` and
``model`` shards: each process attends over its own rows and heads.

- ``impl="xla"``: the plain per-hop ring, differentiable by autograd, the
  counterpart of the JAX ``ppermute`` loop: n steps, each block's logits,
  the online update, then every held rank's K/V and pad shard one hop on
  (the ring's ``permute``).
- ``impl="pallas"``: the two-way ring of ``ops/kernels/ring_attention.py``
  (:class:`RingAttention`; hand-written kernels on CUDA tensors).
"""

from __future__ import annotations

from typing import Optional

import torch

from blt_vqg_tpu_torch.ops.kernels.ring_attention import NEG_INF, RingAttention
from blt_vqg_tpu_torch.parallel import collectives as col


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "seq", causal: bool = False,
                   kv_pad: Optional[torch.Tensor] = None,
                   batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None,
                   impl: str = "xla") -> torch.Tensor:
    """Sequence-parallel attention.  q/k/v [B, T, H, D] (q pre-scaled by
    1/sqrt(D)), T a multiple of the ring size; ``kv_pad`` [B, T] bool (True
    = masked key) travels with K/V.  Returns [B, T, H, D] in q's dtype.
    ``batch_axis``/``head_axis`` name the mesh axes the batch and head dims
    are sharded over (JAX's ``P(batch_axis, axis, head_axis)``): here each
    process already holds its own rows and heads, so they move nothing."""
    del batch_axis, head_axis
    n = mesh.shape[axis]
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"seq len {t} must divide the {axis} axis size {n}")
    c = t // n
    if kv_pad is None:
        kv_pad = torch.zeros((b, t), dtype=torch.bool, device=q.device)
    kv_pad = kv_pad.to(torch.bool).expand(b, t).contiguous()
    ring = mesh.ring(axis)
    if impl == "pallas":
        run = RingAttention.apply
    elif impl == "xla":
        run = _xla_ring
    else:
        raise ValueError(f"impl {impl!r} (want 'xla' or 'pallas')")
    if ring.rank is None:
        def shards(x):   # [B, T, ...] -> the ranks' shards [n, B, C, ...]
            return x.contiguous().view(b, n, c, *x.shape[2:]).transpose(0, 1)

        o = run(shards(q), shards(k), shards(v), shards(kv_pad), ring, causal)
        return o.transpose(0, 1).reshape(b, t, h, d)
    group = mesh.group(axis)
    own = [col.slice_of(x, group, 1)[None] for x in (q, k, v)]
    pad = kv_pad[None, :, ring.rank * c:(ring.rank + 1) * c]
    o = run(*own, pad, ring, causal)
    return col.gather_from(o[0], group, 1, t)


def _xla_ring(q, k, v, pad, ring, causal: bool) -> torch.Tensor:
    """The per-hop ring over the held ranks' shards [held, B, C, H, D], all
    of them at once.  A causal block entirely in the future of a rank's
    queries leaves its carry as it was (the JAX ``lax.cond``)."""
    ring.check(q, k, v, pad)
    n = ring.n
    held, b, c, h, d = q.shape
    dev = q.device
    rank = (ring.rank or 0) + torch.arange(held, device=dev)
    pos = torch.arange(c, device=dev)
    rows = rank[:, None] * c + pos                  # query positions [n, C]
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    m = torch.full((held, b, h, c, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    q32 = q.float()
    k_cur, v_cur, pad_cur = k, v, pad
    for step in range(n):
        src = (rank - step) % n                      # block visiting each rank
        s = torch.einsum("rbqhd,rbkhd->rbhqk", q32, k_cur.float())
        s = s.masked_fill(pad_cur[:, :, None, None, :], NEG_INF)
        if causal:
            cols = src[:, None] * c + pos
            s = s.masked_fill((cols[:, None, :] > rows[:, :, None])
                              [:, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        # the JAX einsum of two v-typed operands returns v's dtype
        pv = torch.einsum("rbhqk,rbkhd->rbqhd", p.to(v.dtype).float(),
                          v_cur.float()).to(v.dtype)
        acc_new = acc * alpha.transpose(2, 3) + pv.float()
        if causal:
            live = (src <= rank).view(held, 1, 1, 1, 1)
            acc = torch.where(live, acc_new, acc)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
        else:
            acc, m, l = acc_new, m_new, l_new
        if step < n - 1:
            k_cur, v_cur, pad_cur = (ring.permute(x) for x in
                                     (k_cur, v_cur, pad_cur))
    l_t = l.transpose(2, 3)
    safe = torch.where(l_t == 0.0, torch.ones_like(l_t), l_t)
    return (acc / safe).to(q.dtype)
