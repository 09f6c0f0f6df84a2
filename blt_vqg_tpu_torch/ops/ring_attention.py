"""Ring attention: sequence-parallel attention over the ``seq`` axis of a
mesh (counterpart of ``blt_vqg_tpu/ops/ring_attention.py``).

The sequence is cut into n equal shards, one per rank of the ring.  Each
rank keeps its query shard and the key/value shards visit it one hop at a
time, combined by an online softmax (running max, denominator and
accumulator in f32); the [T, T] score matrix never exists.  In this port
the ranks are shards on one device (``parallel/mesh.py``).

- ``impl="xla"``: the plain per-hop ring, differentiable by autograd, the
  counterpart of the JAX ``ppermute`` loop: n steps, each block's logits,
  the online update, then every rank's K/V and pad shard one hop on
  (``LocalRing.permute``).
- ``impl="pallas"``: the two-way ring of ``ops/kernels/ring_attention.py``
  (:class:`RingAttention`; hand-written kernels on CUDA tensors).
"""

from __future__ import annotations

from typing import Optional

import torch

from blt_vqg_tpu_torch.ops.kernels.ring_attention import NEG_INF, RingAttention


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "seq", causal: bool = False,
                   kv_pad: Optional[torch.Tensor] = None,
                   batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None,
                   impl: str = "xla") -> torch.Tensor:
    """Sequence-parallel attention.  q/k/v [B, T, H, D] (q pre-scaled by
    1/sqrt(D)), T a multiple of the ring size; ``kv_pad`` [B, T] bool (True
    = masked key) travels with K/V.  Returns [B, T, H, D] in q's dtype.
    ``batch_axis``/``head_axis`` name mesh axes that keep the batch and head
    dims sharded; on one device they must be None or of size 1."""
    n = mesh.shape[axis]
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"seq len {t} must divide the {axis} axis size {n}")
    for name in (batch_axis, head_axis):
        if name is not None and mesh.shape[name] != 1:
            raise NotImplementedError(
                f"mesh axis {name!r} of size {mesh.shape[name]}: attention "
                f"sharded across cards is not ported (ROADMAP.md queue 1, "
                f"item 4)")
    c = t // n
    if kv_pad is None:
        kv_pad = torch.zeros((b, t), dtype=torch.bool, device=q.device)
    kv_pad = kv_pad.to(torch.bool).expand(b, t).contiguous()

    def shards(x):   # [B, T, ...] -> the ranks' shards [n, B, C, ...]
        return x.contiguous().view(b, n, c, *x.shape[2:]).transpose(0, 1)

    ring = mesh.ring(axis)
    args = (shards(q), shards(k), shards(v), shards(kv_pad), ring, causal)
    if impl == "pallas":
        o = RingAttention.apply(*args)
    elif impl == "xla":
        o = _xla_ring(*args)
    else:
        raise ValueError(f"impl {impl!r} (want 'xla' or 'pallas')")
    return o.transpose(0, 1).reshape(b, t, h, d)


def _xla_ring(q, k, v, pad, ring, causal: bool) -> torch.Tensor:
    """The per-hop ring over shards [n, B, C, H, D], every rank at once.  A
    causal block entirely in the future of a rank's queries leaves its
    carry as it was (the JAX ``lax.cond``)."""
    ring.check(q, k, v, pad)
    n, b, c, h, d = q.shape
    dev = q.device
    rank = torch.arange(n, device=dev)
    pos = torch.arange(c, device=dev)
    rows = rank[:, None] * c + pos                  # query positions [n, C]
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    m = torch.full((n, b, h, c, 1), NEG_INF, dtype=torch.float32, device=dev)
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
            live = (src <= rank).view(n, 1, 1, 1, 1)
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
