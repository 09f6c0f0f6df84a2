"""Ring attention over the ranks of a ``seq`` ring (counterpart of
``blt_vqg_tpu/ops/pallas/ring_attention.py``).

The four shard functions keep the JAX names and contracts, for the ring's
n ranks at once: each takes per-rank shards, q/k/v [n, B, C, H, D] (q
already scaled by 1/sqrt(D)) and the key-pad shards [n, B, C] (True =
masked key), and returns per-rank outputs.  Rank r's shard is positions
[r*C, (r+1)*C) of the sequence.

- :func:`ring_attention_fwd_shard`: the one-way ring, n steps; at step s
  rank r attends to the block of rank r - s, which then moves one hop on.
- :func:`ring_attention_fwd_bidir_shard`: blocks travel both ways; at step
  s rank r attends to block r - s (clockwise) and then block r + s
  (counter-clockwise; not at s = 0, nor where it is the clockwise block),
  ``n // 2 + 1`` steps for even n and ``(n - 1) // 2 + 1`` for odd n.
- :func:`ring_attention_bwd_shard`, :func:`ring_attention_bwd_bidir_shard`:
  the FlashAttention-2 backward from the forward's (m, l) on the same
  schedules.  Each block's dK/dV "rider" (f32) travels with it and collects
  a contribution at every rank it visits: one-way, it lands home after n
  hops; two-way, each direction's rider is sent home after the last step,
  and home sums clockwise + counter-clockwise.  dq stays local.

A causal block whose every key lies in the future of every local query is
skipped; the ring still rotates.  The transport is the ``LocalRing`` of
``parallel/mesh.py``: double-buffered slots per rank, a hop is a real copy,
on CUDA on a side stream ordered by events.

On CUDA tensors the block arithmetic runs the kernels of
``csrc/ring_attention.cu``, on one plan (:func:`ring_plan`): per ring step,
one launch (and kernel) covers every rank with a live block there.  The
forward launches once per such step and finalizes each rank inside its
last live step; the backward launches a dK/dV and a dQ kernel per such
step and one landing kernel per call.  Each shard function counts its
launches in ``launches``; anything the kernels cannot take raises.  On
CPU tensors the same schedule runs plain tensor ops per block; the
``*_ref`` functions run that plain version on any device.

The contract kept with the TPU kernels: masked logits take ``NEG_INF`` and
the running max starts there, so a query row whose every visible key is
masked attends uniformly over the keys of the blocks it computed (the
flash kernels output zero there instead); the residuals are (m, safe-l)
[n, B, C, H] f32; p is rounded to v's dtype before the PV product; the
backward casts dO, q, k and v to f32, takes p = exp(s - m) / l, zeroes ds at
masked logits, and rounds dq/dk/dv to the input dtype once, at the end.

:class:`RingAttention` is the differentiable two-way ring that
``ring_attention(impl="pallas")`` installs (ops/ring_attention.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blt_vqg_tpu_torch.ops.kernels.flash_attention import _on_cuda

NEG_INF = -1e30
MAX_HEAD_DIM = 256         # as the flash and decode kernels


def ring_steps(n: int, bidir: bool) -> int:
    """Compute steps of the one-way (n) or two-way ring."""
    if not bidir:
        return n
    return n // 2 + 1 if n % 2 == 0 else (n - 1) // 2 + 1


def visits(n: int, step: int, rank: int, causal: bool, bidir: bool):
    """[(direction index, source rank)] of the blocks ``rank`` computes at
    ``step``, in order: the clockwise block, then the counter-clockwise
    one.  A causal block is live when its first key is not past the rank's
    last query: ``src * C <= rank * C + C - 1``, i.e. ``src <= rank``."""
    out = []
    cw = (rank - step) % n
    if not causal or cw <= rank:
        out.append((0, cw))
    if bidir and step >= 1:
        ccw = (rank + step) % n
        if ccw != cw and (not causal or ccw <= rank):
            out.append((1, ccw))
    return out


@functools.cache
def ring_plan(n: int, causal: bool, bidir: bool, rank=None):
    """The kernels' launches in both directions: for each step, the ranks
    with a live block there, as (rank, visits, first, last) with the rank's
    visits at that step and whether it is the rank's first and its last
    live step (where a carry starts, and where the forward finalizes it).
    A step with no live rank launches nothing (its hops still run).

    With ``rank``, the plan of that one rank of a ring across processes,
    relabelled for a process that holds only that rank: its entries name
    rank 0 and each visit's source ``src - rank``.  Every use of a rank and
    a source (here and in the kernels) is a slot index or a difference of
    sequence offsets, so the relabelled plan computes the same blocks."""
    steps = ring_steps(n, bidir)
    live = [[tuple(visits(n, s, r, causal, bidir)) for r in range(n)]
            for s in range(steps)]
    plan = tuple(
        tuple((r, live[s][r], not any(live[u][r] for u in range(s)),
               not any(live[u][r] for u in range(s + 1, steps)))
              for r in range(n) if live[s][r])
        for s in range(steps))
    if rank is None:
        return plan
    return tuple(
        tuple((0, tuple((i, src - rank) for i, src in vis), first, last)
              for r, vis, first, last in entries if r == rank)
        for entries in plan)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ring_attention: {msg}")


def _local(x: torch.Tensor) -> torch.Tensor:
    """x [n, B, ...] laid out as the ranks' rows of the whole sequence
    (storage [B, n, ...]): a view where it already is, else one copy."""
    return x.transpose(0, 1).contiguous().transpose(0, 1)


def _empty_local(shape, dtype, device) -> torch.Tensor:
    n, b = shape[:2]
    return torch.empty((b, n, *shape[2:]), dtype=dtype,
                       device=device).transpose(0, 1)


def _validate(ring, q, k, v, pad):
    _check(q.dim() == 5 and k.shape == q.shape and v.shape == q.shape,
           f"shards q {tuple(q.shape)}, k {tuple(k.shape)}, v "
           f"{tuple(v.shape)} must share one [n, B, C, H, D] shape")
    n, b, c = q.shape[:3]
    _check(n == ring.held, f"{n} shards on a ring that holds {ring.held} "
                           f"of its {ring.n} ranks here")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and k.dtype == q.dtype and v.dtype == q.dtype,
           f"dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    _check(pad.dtype == torch.bool and tuple(pad.shape) == (n, b, c),
           f"pad must be bool [{n}, {b}, {c}]")
    ring.check(q, k, v, pad)


# ---------------------------------------------------------------------------
# the block arithmetic: plain tensor ops

def _logits(q, k, pad, q_off: int, k_off: int, causal: bool):
    """f32 logits [B, H, Cq, Ck] of one rank against one visiting block,
    masked entries at ``NEG_INF``."""
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
    s = s.masked_fill(pad[:, None, None, :], NEG_INF)
    if causal:
        c = q.shape[1]
        idx = torch.arange(c, device=q.device)
        s = s.masked_fill((k_off + idx)[None, :] > (q_off + idx)[:, None],
                          NEG_INF)
    return s


class _PlainFwd:
    """Forward carry per rank: acc [B, H, C, D], m and l [B, H, C], f32."""

    def __init__(self, q, causal, plan):
        n, b, c, h, d = q.shape
        self.q, self.causal, self.plan = q, causal, plan
        self.acc = torch.zeros((n, b, h, c, d), dtype=torch.float32,
                               device=q.device)
        self.m = torch.full((n, b, h, c), NEG_INF, dtype=torch.float32,
                            device=q.device)
        self.l = torch.zeros((n, b, h, c), dtype=torch.float32,
                             device=q.device)

    def step(self, s: int, slots) -> None:
        """Step s: each live rank against its visiting blocks in turn."""
        c = self.q.shape[2]
        for r, vis, _, _ in self.plan[s]:
            for i, src in vis:
                k, v, pad = (t[r] for t in slots[i])
                logit = _logits(self.q[r], k, pad, r * c, src * c,
                                self.causal)
                m_prev = self.m[r]
                m_new = torch.maximum(m_prev, logit.amax(dim=-1))
                p = torch.exp(logit - m_new[..., None])
                alpha = torch.exp(m_prev - m_new)
                self.l[r] = self.l[r] * alpha + p.sum(dim=-1)
                self.acc[r] = self.acc[r] * alpha[..., None] + torch.einsum(
                    "bhij,bjhd->bhid", p.to(v.dtype).float(), v.float())
                self.m[r] = m_new

    def finalize(self):
        safe = torch.where(self.l == 0.0, torch.ones_like(self.l), self.l)
        o = (self.acc / safe[..., None]).to(self.q.dtype)
        return (_local(o.permute(0, 1, 3, 2, 4)),
                _local(self.m.transpose(2, 3)), _local(safe.transpose(2, 3)))


class _PlainBwd:
    """Backward per rank: dq carry [B, C, H, D] f32; riders [2, B, C, H, D]
    f32 (dk, dv) in the ring's slots."""

    def __init__(self, q, do, m, l, delta, causal, plan):
        self.q, self.do, self.causal, self.plan = q, do, causal, plan
        self.m, self.linv = m.transpose(2, 3), (1.0 / l).transpose(2, 3)
        self.delta = delta.transpose(2, 3)          # [n, B, H, C]
        self.dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    def step(self, s: int, slots, riders) -> None:
        """Step s: each live rank against its visiting blocks in turn,
        adding into the blocks' riders and its own dq."""
        c = self.q.shape[2]
        for r, vis, _, _ in self.plan[s]:
            q32, do32 = self.q[r].float(), self.do[r].float()
            for i, src in vis:
                k, v, pad = (t[r] for t in slots[i])
                rider = riders[i][r]
                logit = _logits(self.q[r], k, pad, r * c, src * c,
                                self.causal)
                p = (torch.exp(logit - self.m[r][..., None])
                     * self.linv[r][..., None])
                rider[1] += torch.einsum("bhij,bihd->bjhd", p, do32)
                dp = torch.einsum("bihd,bjhd->bhij", do32, v.float())
                ds = p * (dp - self.delta[r][..., None])
                ds = torch.where(logit <= 0.5 * NEG_INF, torch.zeros_like(ds),
                                 ds)
                rider[0] += torch.einsum("bhij,bihd->bjhd", ds, q32)
                self.dq[r] += torch.einsum("bhij,bjhd->bihd", ds, k.float())

    def land(self, homes, dtype):
        dk = homes[0][:, 0]
        dv = homes[0][:, 1]
        if len(homes) > 1:
            dk, dv = dk + homes[1][:, 0], dv + homes[1][:, 1]
        return (_local(self.dq.to(dtype)), _local(dk.to(dtype)),
                _local(dv.to(dtype)))


# ---------------------------------------------------------------------------
# the block arithmetic: the kernels of csrc/ring_attention.cu

@functools.cache
def _step_tables(n: int, causal: bool, bidir: bool, rank=None):
    """Each step's ``RingStep`` (None where no rank is live): the plan's
    entries (of ``rank`` alone on a ring across processes), and the
    (entry, visiting block) pairs of the backward's dK/dV launch."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    tables = []
    for entries in ring_plan(n, causal, bidir, rank):
        if not entries:
            tables.append(None)
            continue
        t = _build.RingStep(nent=len(entries))
        for e, (r, vis, first, last) in enumerate(entries):
            info = len(vis) | first << 2 | last << 3
            for j, (direction, src) in enumerate(vis):
                info |= direction << (4 + j)
                t.src[2 * e + j] = src
                t.pair[t.npair] = 2 * e + j
                t.npair += 1
            t.rank[e], t.info[e] = r, info
        tables.append(t)
    return tuple(tables)


def _laid_out(x, strides) -> bool:
    """x has these strides, up to those of its dimensions of size 1."""
    return all(st == want or n == 1
               for st, want, n in zip(x.stride(), strides, x.shape))


class _Kernels:
    """What the forward and the backward kernels share: the checks, the
    library, the stream, the step tables and one counted launch."""

    def __init__(self, q, ring, causal, bidir, counter):
        from blt_vqg_tpu_torch.ops.kernels import _build

        n, b, c, h, d = q.shape
        _check(0 < d <= MAX_HEAD_DIM, f"head dim {d} (at most "
                                      f"{MAX_HEAD_DIM} on the kernels)")
        _check(n <= _build.RING_MAX_RANKS,
               f"{n} ranks (at most {_build.RING_MAX_RANKS} on the kernels)")
        # the rank stride: one held rank (a ring across processes) has
        # rows of its own, and a dimension of size 1 any stride
        self.rs = c * h * d if n == 1 else q.stride(0)
        _check(self.rs == c * h * d, "q must hold the ranks' rows")
        self._check, self.lib = _build.check, _build.library()
        self.stream = torch.cuda.current_stream(q.device).cuda_stream
        self.counter = counter
        self.tables = _step_tables(ring.n, causal, bidir, ring.rank)

    def launch(self, entry: str, args) -> None:
        """One kernel launch on the compute stream, counted."""
        err = getattr(self.lib, entry)(ctypes.byref(args), self.stream)
        self._check(self.lib, err, entry)
        self.counter.launches += 1


class _KernelFwd(_Kernels):
    """The forward kernels: the argument struct is built once per call; a
    step sets its slots and its table of live ranks and launches once."""

    def __init__(self, q, ring, causal, bidir, counter):
        from blt_vqg_tpu_torch.ops.kernels import _build

        super().__init__(q, ring, causal, bidir, counter)
        n, b, c, h, d = q.shape
        self.q = q          # the struct points at q and the carry: kept alive
        self.acc = _empty_local(q.shape, torch.float32, q.device)
        self.o = _empty_local(q.shape, q.dtype, q.device)
        self.m = _empty_local((n, b, c, h), torch.float32, q.device)
        self.l = torch.empty_like(self.m)
        self.args = _build.RingFwdArgs(
            act_bf16=int(q.dtype == torch.bfloat16), causal=int(causal),
            batch=b, heads=h, chunk=c, dim=d, rs=self.rs,
            sb=q.stride(1), slot_rs=b * c * h * d, q=q.data_ptr(),
            acc=self.acc.data_ptr(), m=self.m.data_ptr(),
            l=self.l.data_ptr(), o=self.o.data_ptr())

    def step(self, s: int, slots) -> None:
        """Step s's launch on the slots of each direction, counted."""
        if self.tables[s] is None:
            return
        a = self.args
        for i, (k, v, pad) in enumerate(slots):
            a.k[i], a.v[i], a.pad[i] = (k.data_ptr(), v.data_ptr(),
                                        pad.data_ptr())
        a.step = self.tables[s]
        self.launch("bvq_ring_fwd_step", a)

    def finalize(self):
        return self.o, self.m, self.l


class _KernelBwd(_Kernels):
    """The backward kernels: the argument struct is built once per call; a
    step sets its slots, its riders and its table and launches the dK/dV
    and the dQ kernel once each; one landing launch ends the call."""

    def __init__(self, q, do, m, l, delta, ring, causal, bidir, counter):
        from blt_vqg_tpu_torch.ops.kernels import _build

        super().__init__(q, ring, causal, bidir, counter)
        n, b, c, h, d = q.shape
        rows = (self.rs // d, q.stride(1) // d, h, 1)
        _check(_laid_out(do, q.stride()), "dO must be laid out as q")
        _check(all(_laid_out(x, rows) for x in (m, l, delta)),
               "m, l and delta must be laid out as q's rows")
        self.q = q
        self.keep = (do, m, l, delta)   # the struct points at them
        self.dq = _empty_local(q.shape, torch.float32, q.device)
        self.args = _build.RingBwdArgs(
            act_bf16=int(q.dtype == torch.bfloat16), causal=int(causal),
            ranks=n, batch=b, heads=h, chunk=c, dim=d, rs=self.rs,
            sb=q.stride(1), slot_rs=b * c * h * d, q=q.data_ptr(),
            dout=do.data_ptr(), m=m.data_ptr(), l=l.data_ptr(),
            delta=delta.data_ptr(), dq=self.dq.data_ptr())

    def step(self, s: int, slots, riders) -> None:
        """Step s's two launches on the slots and the riders of each
        direction, counted."""
        if self.tables[s] is None:
            return
        a = self.args
        for i, ((k, v, pad), rider) in enumerate(zip(slots, riders)):
            a.k[i], a.v[i], a.pad[i], a.rider[i] = (
                k.data_ptr(), v.data_ptr(), pad.data_ptr(), rider.data_ptr())
        a.step = self.tables[s]
        self.launch("bvq_ring_bwd_dkdv", a)
        self.launch("bvq_ring_bwd_dq", a)

    def land(self, homes, dtype):
        dq, dk, dv = (_empty_local(self.q.shape, dtype, self.q.device)
                      for _ in range(3))
        a = self.args
        a.dq_out, a.dk, a.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
        a.ret[0] = homes[0].data_ptr()
        a.ret[1] = homes[1].data_ptr() if len(homes) > 1 else None
        self.launch("bvq_ring_land", a)
        return dq, dk, dv


# ---------------------------------------------------------------------------
# the schedules

def _kv_channels(ring, k, v, pad, bidir: bool):
    n, b, c, h, d = k.shape
    payloads = [((b, c, h, d), k.dtype), ((b, c, h, d), v.dtype),
                ((b, c), torch.bool)]
    chans = [ring.channel(payloads, +1)]
    if bidir:
        chans.append(ring.channel(payloads, -1))
    for ch in chans:
        ch.seed(k, v, pad)
    return chans


def _ring_fwd(q, k, v, pad, ring, causal: bool, bidir: bool, kernel: bool,
              counter=None):
    """(o, m, l) of every rank: o [n, B, C, H, D] in q's dtype, m and the
    safe l [n, B, C, H] f32."""
    _validate(ring, q, k, v, pad)
    q = _local(q)
    plan = ring_plan(ring.n, causal, bidir, ring.rank)
    ops = (_KernelFwd(q, ring, causal, bidir, counter) if kernel
           else _PlainFwd(q, causal, plan))
    chans = _kv_channels(ring, k, v, pad, bidir)
    steps = len(plan)
    for s in range(steps):
        if s < steps - 1:
            for ch in chans:       # the next hop rides while this step runs
                ch.send(s)
        ops.step(s, [ch.slot(s) for ch in chans])
        for ch in chans:
            ch.release()
    out = ops.finalize()
    ring.join()
    return out


def _ring_bwd(q, k, v, pad, o, m, l, do, ring, causal: bool, bidir: bool,
              kernel: bool, counter=None):
    """(dq, dk, dv) of every rank, in the inputs' dtypes."""
    _validate(ring, q, k, v, pad)
    n, b, c, h, d = q.shape
    _check(o.shape == q.shape and do.shape == q.shape
           and do.dtype == q.dtype, "o and dO must be shaped and typed as q")
    _check(m.shape == (n, b, c, h) and l.shape == m.shape
           and m.dtype == torch.float32 and l.dtype == torch.float32,
           f"m and l must be f32 [{n}, {b}, {c}, {h}]")
    q, do, m, l = _local(q), _local(do), _local(m), _local(l)
    delta = _local((do.float() * o.float()).sum(dim=-1))
    plan = ring_plan(ring.n, causal, bidir, ring.rank)
    ops = (_KernelBwd(q, do, m, l, delta, ring, causal, bidir, counter)
           if kernel else _PlainBwd(q, do, m, l, delta, causal, plan))
    chans = _kv_channels(ring, k, v, pad, bidir)
    riders = [ring.channel([((2, b, c, h, d), torch.float32)], ch.direction)
              for ch in chans]
    for rc in riders:
        rc.seed(None)
    homes = ([torch.empty((n, 2, b, c, h, d), dtype=torch.float32,
                          device=q.device) for _ in riders] if bidir else None)
    steps = len(plan)
    for s in range(steps):
        if s < steps - 1:
            for ch in chans:
                ch.send(s)
        ops.step(s, [ch.slot(s) for ch in chans],
                 [rc.slot(s)[0] for rc in riders])
        for ch in chans + riders:
            ch.release()
        # each rider's payload is complete only now: it moves on after the
        # step, or (two-way, last step) goes straight home
        for i, rc in enumerate(riders):
            if not bidir or s < steps - 1:
                rc.send(s)
            else:
                rc.send(s, hops=-s, out=[homes[i]])
    ring.join()
    if not bidir:            # home after a hop per rank of the ring
        homes = [riders[0].bufs[0][ring.n % 2]]
    return ops.land(homes, q.dtype)


# ---------------------------------------------------------------------------
# the shard functions

def ring_attention_fwd_shard(q, k, v, pad, *, ring, causal: bool,
                             return_lse: bool = False):
    """One-way ring forward: o [n, B, C, H, D] (and, with ``return_lse``,
    the residuals m and safe l [n, B, C, H] f32).  Kernels on CUDA tensors,
    the plain version on CPU tensors."""
    o, m, l = _ring_fwd(q, k, v, pad, ring, causal, False,
                        _on_cuda(q, "ring_attention_fwd_shard"),
                        ring_attention_fwd_shard)
    return (o, m, l) if return_lse else o


def ring_attention_fwd_bidir_shard(q, k, v, pad, *, ring, causal: bool,
                                   return_lse: bool = False):
    """Two-way ring forward (shapes as :func:`ring_attention_fwd_shard`)."""
    o, m, l = _ring_fwd(q, k, v, pad, ring, causal, True,
                        _on_cuda(q, "ring_attention_fwd_bidir_shard"),
                        ring_attention_fwd_bidir_shard)
    return (o, m, l) if return_lse else o


def ring_attention_bwd_shard(q, k, v, pad, o, m, l, do, *, ring,
                             causal: bool):
    """One-way ring backward from the forward's (o, m, l): (dq, dk, dv)
    [n, B, C, H, D] in the inputs' dtypes."""
    return _ring_bwd(q, k, v, pad, o, m, l, do, ring, causal, False,
                     _on_cuda(q, "ring_attention_bwd_shard"),
                     ring_attention_bwd_shard)


def ring_attention_bwd_bidir_shard(q, k, v, pad, o, m, l, do, *, ring,
                                   causal: bool):
    """Two-way ring backward (shapes as :func:`ring_attention_bwd_shard`)."""
    return _ring_bwd(q, k, v, pad, o, m, l, do, ring, causal, True,
                     _on_cuda(q, "ring_attention_bwd_bidir_shard"),
                     ring_attention_bwd_bidir_shard)


def ring_attention_fwd_shard_ref(q, k, v, pad, *, ring, causal: bool):
    """The plain one-way forward on any device: (o, m, l)."""
    return _ring_fwd(q, k, v, pad, ring, causal, False, kernel=False)


def ring_attention_fwd_bidir_shard_ref(q, k, v, pad, *, ring, causal: bool):
    """The plain two-way forward on any device: (o, m, l)."""
    return _ring_fwd(q, k, v, pad, ring, causal, True, kernel=False)


def ring_attention_bwd_shard_ref(q, k, v, pad, o, m, l, do, *, ring,
                                 causal: bool):
    """The plain one-way backward on any device: (dq, dk, dv)."""
    return _ring_bwd(q, k, v, pad, o, m, l, do, ring, causal, False,
                     kernel=False)


def ring_attention_bwd_bidir_shard_ref(q, k, v, pad, o, m, l, do, *, ring,
                                       causal: bool):
    """The plain two-way backward on any device: (dq, dk, dv)."""
    return _ring_bwd(q, k, v, pad, o, m, l, do, ring, causal, True,
                     kernel=False)


for _fn in (ring_attention_fwd_shard, ring_attention_fwd_bidir_shard,
            ring_attention_bwd_shard, ring_attention_bwd_bidir_shard):
    _fn.launches = 0


class RingAttention(torch.autograd.Function):
    """The differentiable two-way ring: the forward runs
    :func:`ring_attention_fwd_bidir_shard` and saves (q, k, v, pad, o, m,
    l); the backward runs :func:`ring_attention_bwd_bidir_shard` (which
    takes delta = rowsum(dO * O) in f32 outside the kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, pad, ring, causal):
        o, m, l = ring_attention_fwd_bidir_shard(q, k, v, pad, ring=ring,
                                                 causal=causal,
                                                 return_lse=True)
        ctx.save_for_backward(q, k, v, pad, o, m, l)
        ctx.ring, ctx.causal = ring, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pad, o, m, l = ctx.saved_tensors
        dq, dk, dv = ring_attention_bwd_bidir_shard(
            q, k, v, pad, o, m, l, do, ring=ctx.ring, causal=ctx.causal)
        return dq, dk, dv, None, None, None
