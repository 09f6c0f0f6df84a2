"""Blockwise flash attention with a FlashAttention-2 backward (counterpart
of ``blt_vqg_tpu/ops/pallas/flash_attention.py``).

:func:`flash_attention` keeps the JAX function's contract: q [B, Tq, H, D]
already scaled by 1/sqrt(D), k/v [B, Tk, H, D], ``kv_pad`` bool [B, Tk]
(True = masked key), ``causal`` masks key j > query i; it returns
[B, Tq, H, D] and is differentiable through :class:`FlashAttention`, whose
forward saves (o, m, l) and whose backward runs the two backward kernels.

On CUDA tensors the kernels of ``csrc/flash_attention.cu`` run
(:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dkdv`,
:func:`flash_attention_bwd_dq`, each counting its ``launches``); anything
they cannot take raises.  bf16 runs ``flash_fwd_mma_kernel``,
``flash_bwd_dkdv_mma_kernel`` and ``flash_bwd_dq_mma_kernel`` on the
tensor cores, in the tiling that :func:`mma_geom` computes here and passes
in the launch's arguments; f32 runs f32 FMA tiles.  On CPU tensors the
plain versions run: :func:`flash_attention_fwd_ref` and
:func:`flash_attention_bwd_ref`, the FlashAttention-2 recurrence over a
single key tile.

The contract the kernels keep with the TPU kernels: masked logits take
``NEG_INF``; a query row whose every visible key is masked outputs zero and
gets zero gradients (plain softmax would give a uniform row); the residuals
are the running max m and the "safe" denominator l (1 where it is 0, and 1
on such dead rows), both f32 [B, H, Tq]; p is rounded to v's dtype before
the PV product; the backward casts dO, q, k and v to f32 and zeroes ds at
masked logits; dq/dk/dv come back in the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256         # as the decode kernels (decode_layer.py)
MMA_WARPS = 4              # warps of a tensor-core kernel's block (but
                           # 8 for the pair backward's 64 rows: mma_geom)
SM_SMEM = 233_472          # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED = 1_024     # shared memory the card reserves per block
MMA_BLOCKS_PER_SM = 2      # FM_BLOCKS_PER_SM: the kernels' register cap
PAIR_DQ_BLOCKS_PER_SM = 3  # the dQ pair kernel's (FMP_DQ_MAX_REGS, 4 warps)
MMA_KERNELS = ("fwd", "dkdv", "dq")


def _logits(q, k, kv_pad, causal):
    """f32 logits [B, H, Tq, Tk] with masked entries at ``NEG_INF``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    tq, tk = q.shape[1], k.shape[1]
    if kv_pad is not None:
        s = s.masked_fill(kv_pad[:, None, None, :], NEG_INF)
    if causal:
        future = torch.ones((tq, tk), dtype=torch.bool,
                            device=q.device).triu(1)
        s = s.masked_fill(future, NEG_INF)
    return s


def _dead(m):
    return m <= 0.5 * NEG_INF


def flash_attention_fwd_ref(q, k, v, kv_pad=None, causal: bool = False):
    """Plain forward: (o [B, Tq, H, D] in q's dtype, m, l [B, H, Tq] f32)."""
    s = _logits(q, k, kv_pad, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    dead = _dead(m)
    o = torch.where(dead.transpose(1, 2)[..., None], torch.zeros_like(acc),
                    acc / safe.transpose(1, 2)[..., None])
    return (o.to(q.dtype), m,
            torch.where(dead, torch.ones_like(safe), safe))


def row_delta(do, o):
    """rowsum(dO * O) in f32, [B, H, Tq]."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, kv_pad, o, m, l, do,
                            causal: bool = False):
    """Plain backward from the saved (o, m, l): (dq, dk, dv) in the input
    dtype."""
    s = _logits(q, k, kv_pad, causal)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    p = torch.where(_dead(m)[..., None], torch.zeros_like(p), p)
    do32 = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = p * (dp - row_delta(do, o)[..., None])
    ds = torch.where(s <= 0.5 * NEG_INF, torch.zeros_like(ds), ds)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def mma_blocks_per_sm(kernel: str, dim: int, warps: int) -> int:
    """The blocks of ``warps`` warps that the registers of ``kernel``'s
    instantiation for head dim ``dim`` let an SM hold: the kernels up to
    head dim 128 and the forward above it are bounded for 2 blocks of 4
    warps; above it the dQ kernel is capped for 3 and the dK/dV kernel
    (uncapped, over 128 registers a thread) holds 2; an 8-warp block
    holds the SM alone."""
    if warps > MMA_WARPS:
        return 1
    if _up(dim, 16) > 128 and kernel == "dq":
        return PAIR_DQ_BLOCKS_PER_SM
    return MMA_BLOCKS_PER_SM


def mma_geom(kernel: str, tq: int, tk: int, dim: int, batch_heads: int):
    """The tiling of a bf16 tensor-core kernel (``bvq::FlashGeom``):
    ``kernel`` is "fwd", "dkdv" or "dq".

    A warp owns 16 rows of one (b, h): the dK/dV kernel's are keys (length
    ``tk``), the forward's and the dQ kernel's queries (``tq``).  A (b, h)
    takes ``wq`` = 1, 2 or 4 warps for an owned length up to 16, up to 32,
    or longer; a block of 4 warps holds ``groups`` = 4 / wq consecutive
    (b, h) (neighbouring heads of one batch row), and block (x, y) serves
    (b, h) ``x * groups`` .. + groups - 1 (those past B*H idle) and owned
    rows ``16 wq y`` .. + 16 wq - 1 (warp w: 16 (w % wq) on).  The other
    side's rows are walked in tiles of ``kt`` rows (their length rounded
    up to 16, at most 64, and less where the block would not fit on an SM
    as often as its registers allow (`mma_blocks_per_sm`): a short owned
    side with a long walked one), through two stages when there is more
    than one tile (above head dim 128 even 16-row tiles may leave a block
    fewer SM places).  The head dim is zero-padded to ``dp`` (a multiple
    of 16) in rows of ``lds`` = dp + 8 elements.  Per group, ``fixed``
    bytes hold the dK/dV kernel's K and V or the forward's q rows (f32,
    rows of dp + 4), and a stage holds the walked q and dO (and the rows'
    m, l, delta) or K and V (and the keys' pad bytes).

    Above head dim 128 all three kernels give each 16 owned rows a pair of
    warps, one for each half of the accumulators' columns: ``wq`` counts a
    (b, h)'s row tiles of 16 in a block and a block holds 2 tiles
    (``groups`` = 2 / wq), or, in the backward kernels at an owned length
    above 32, 4 tiles of one (b, h) on 8 warps (``wq`` 4, ``groups`` 1);
    the forward's ``wq`` is 1 for Tq up to 16 and 2 above.  The forward's
    ``fixed`` also holds the group's p rows (f32, rows of kt + 8) and two
    f32 a row (the halves' row maxima); the backward's holds the owned rows
    (dK/dV: K and V; dQ: q and dO) and its pairs' exchange buffers, 2 x 2
    x N x 32 words of 16 bytes a tile (N: dK/dV 2, dQ 1)."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    _check(kernel in MMA_KERNELS, f"no tensor-core kernel {kernel!r}")
    dkdv = kernel == "dkdv"
    own_len, walked = (tk, tq) if dkdv else (tq, tk)
    dp = _up(dim, 16)
    pair = dp > 128
    wq = (1 if own_len <= 16 else 2 if own_len <= 32
          or (pair and kernel == "fwd") else 4)
    warps = 2 * MMA_WARPS if pair and wq == 4 else MMA_WARPS
    groups = warps // (wq * (2 if pair else 1))
    own = 16 * wq
    lds = dp + 8
    budget = (SM_SMEM // mma_blocks_per_sm(kernel, dim, warps)
              - BLOCK_RESERVED)
    for kt in range(min(_up(walked, 16), 64), 0, -16):   # 16 at the least
        if kernel == "fwd":
            fixed = own * (dp + 4) * 4
            if pair:
                fixed += own * (kt + 8) * 4 + own * 8
        elif dkdv or pair:
            fixed = 2 * own * lds * 2
            if pair:
                fixed += wq * 2 * 2 * (2 if dkdv else 1) * 32 * 16
        else:
            fixed = 0
        stage = _up(2 * kt * lds * 2 + (3 * kt * 4 if dkdv else kt), 16)
        nst = 2 if walked > kt else 1
        if groups * (fixed + nst * stage) <= budget:
            break
    return _build.FlashGeom(
        wq=wq, groups=groups, kt=kt, dp=dp, lds=lds, fixed=fixed,
        stage=stage, nst=nst, smem=groups * (fixed + nst * stage),
        grid_x=-(-batch_heads // groups), grid_y=-(-own_len // (16 * wq)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _args(q, k, v, kv_pad, causal, kernel: str, **ptrs):
    """Validates the operands of a launch of ``kernel`` ("fwd", "dkdv" or
    "dq") and packs its arguments; a bf16 launch gets its tiling."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    _check(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
           f"v {tuple(v.shape)}")
    b, tq, h, d = q.shape
    _check(k.shape[0] == b and k.shape[2] == h and k.shape[3] == d,
           f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and k.dtype == q.dtype and v.dtype == q.dtype,
           f"dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    _check(d % 8 == 0 and 0 < d <= MAX_HEAD_DIM,
           f"head dim {d} (a multiple of 8 up to {MAX_HEAD_DIM})")
    for t in (q, k, v):
        _check(t.device == q.device and t.is_contiguous(),
               "q, k, v must be contiguous on one device")
    if kv_pad is not None:
        _check(kv_pad.dtype == torch.bool
               and tuple(kv_pad.shape) == (b, k.shape[1])
               and kv_pad.device == q.device and kv_pad.is_contiguous(),
               f"kv_pad must be contiguous bool [{b}, {k.shape[1]}]")
    bf16 = q.dtype == torch.bfloat16
    geom = (mma_geom(kernel, tq, k.shape[1], d, b * h) if bf16
            else _build.FlashGeom())
    return _build.FlashCall(a=_build.FlashArgs(
        act_bf16=int(bf16), causal=int(causal), batch=b, heads=h, tq=tq,
        tk=k.shape[1], dim=d, q=q.data_ptr(), k=k.data_ptr(),
        v=v.data_ptr(), kv_pad=None if kv_pad is None else kv_pad.data_ptr(),
        **{name: t.data_ptr() for name, t in ptrs.items()}), geom=geom)


def _launch(entry: str, a, device) -> None:
    from blt_vqg_tpu_torch.ops.kernels import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib, getattr(lib, entry)(ctypes.byref(a), stream), entry)


def _on_cuda(q, what: str) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return q.device.type == "cuda"


def flash_attention_fwd(q, k, v, kv_pad=None, causal: bool = False):
    """(o, m, l): the forward kernel on CUDA tensors, the plain version on
    CPU tensors.  ``flash_attention_fwd.launches`` counts kernel launches."""
    if not _on_cuda(q, "flash_attention_fwd"):
        return flash_attention_fwd_ref(q, k, v, kv_pad, causal)
    b, tq, h, _ = q.shape
    o = torch.empty_like(q)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("bvq_flash_fwd",
            _args(q, k, v, kv_pad, causal, "fwd", o=o, m=m, l=l), q.device)
    flash_attention_fwd.launches += 1
    return o, m, l


def flash_attention_bwd_dkdv(q, k, v, kv_pad, m, l, do, delta,
                             causal: bool = False):
    """(dk, dv) by the dK/dV kernel (CUDA tensors only); ``delta`` is
    rowsum(dO * O) f32 [B, H, Tq].  Counts ``launches``."""
    _check(_on_cuda(q, "flash_attention_bwd_dkdv"),
           "the dK/dV kernel takes CUDA tensors")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bvq_flash_bwd_dkdv",
            _args(q, k, v, kv_pad, causal, "dkdv",
                  **_bwd_ptrs(q, m, l, do, delta), dk=dk, dv=dv), q.device)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, kv_pad, m, l, do, delta,
                           causal: bool = False):
    """dq by the dQ kernel (CUDA tensors only).  Counts ``launches``."""
    _check(_on_cuda(q, "flash_attention_bwd_dq"),
           "the dQ kernel takes CUDA tensors")
    dq = torch.empty_like(q)
    _launch("bvq_flash_bwd_dq",
            _args(q, k, v, kv_pad, causal, "dq",
                  **_bwd_ptrs(q, m, l, do, delta), dq=dq), q.device)
    flash_attention_bwd_dq.launches += 1
    return dq


def _bwd_ptrs(q, m, l, do, delta):
    b, tq, h, _ = q.shape
    for name, t in (("m", m), ("l", l), ("delta", delta)):
        _check(t.dtype == torch.float32 and tuple(t.shape) == (b, h, tq)
               and t.is_contiguous() and t.device == q.device,
               f"{name} must be contiguous f32 [{b}, {h}, {tq}]")
    _check(do.shape == q.shape and do.dtype == q.dtype
           and do.is_contiguous() and do.device == q.device,
           "dO must be contiguous, shaped and typed as q")
    return {"m": m, "l": l, "dout": do, "delta": delta}


flash_attention_fwd.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, kv_pad, o, m, l, do, causal: bool = False):
    """(dq, dk, dv): the two backward kernels on CUDA tensors (delta as a
    tensor expression), the plain version on CPU tensors."""
    if not _on_cuda(q, "flash_attention_bwd"):
        return flash_attention_bwd_ref(q, k, v, kv_pad, o, m, l, do, causal)
    do = do.contiguous()
    delta = row_delta(do, o)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, kv_pad, m, l, do, delta,
                                      causal)
    dq = flash_attention_bwd_dq(q, k, v, kv_pad, m, l, do, delta, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward saves (o, m, l), the
    backward recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, kv_pad, causal):
        o, m, l = flash_attention_fwd(q, k, v, kv_pad, causal)
        ctx.save_for_backward(q, k, v, kv_pad, o, m, l)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_pad, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_pad, o, m, l, do,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_pad: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention, differentiable.  q [B, Tq, H, D] (pre-scaled by
    1/sqrt(D)), k/v [B, Tk, H, D], kv_pad bool [B, Tk] (True = masked key);
    returns [B, Tq, H, D]."""
    if kv_pad is not None:
        kv_pad = kv_pad.to(torch.bool).contiguous()
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), kv_pad, causal)
