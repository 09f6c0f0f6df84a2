"""The per-layer decode step as two fused ops (counterpart of
``blt_vqg_tpu/ops/pallas/decode_layer.py``).

- :func:`self_attn_step`: LayerNorm -> per-head QKV -> K/V written into the
  caches at ``pos`` in place -> causal cached attention (optional pad-key
  mask) -> out projection summed over heads -> residual;
- :func:`cross_ffn_step`: LayerNorm -> cross-attention over the
  precomputed encoder K/V with the source pad mask -> out projection ->
  residual -> LayerNorm -> FFN (ReLU, biases) -> residual.

Both keep the JAX functions' signatures and layouts (caches [H, L, B, Dh],
``w_qkv`` [H, D, 3*Dh], ``w_out`` [H, Dh, D], weights in flax's [in, out]
layout).  On CUDA tensors they launch the kernels of
``csrc/decode_layer.cu``; on CPU tensors they compute the plain versions
:func:`self_attn_step_ref` and :func:`cross_ffn_step_ref`.

Numerics copied from the TPU kernels, in both versions:

- LayerNorm in f32, its output rounded to the compute dtype (``x.dtype``)
  before each product; every product accumulates in f32;
- ``q`` stays f32, scaled by Dh^-0.5; k and v are rounded to the cache
  dtype, written at ``pos``, and read back (that row included) as f32;
- future rows take ``NEG_INF``; pad-marked keys take ``PAD_FILL`` above it,
  applied over every row, so ``key_pad`` must never mark a row past
  ``pos``; a source row whose every key is masked gets uniform weights (the
  plain softmax over equal fills);
- the context is rounded to the compute dtype before the out projection;
  the self-attention output is rounded to ``x.dtype`` after each head, in
  head order 0..H-1 (the TPU grid runs the heads in sequence);
- in :func:`cross_ffn_step` x stays f32 from the cross-attention residual
  through the FFN and is rounded once at the end; ``b1`` is added before
  the ReLU, ``b2`` after the second product's residual.
"""

from __future__ import annotations

import ctypes

import torch

from blt_vqg_tpu_torch.ops.kernels.decode_stream import (gemm_workspace,
                                                          layernorm, scratch)
from blt_vqg_tpu_torch.ops.masks import MASK_FILL

NEG_INF = -1e30
PAD_FILL = MASK_FILL        # strictly above NEG_INF (see the module notes)
_ACT_DTYPES = (torch.float32, torch.bfloat16)


def _dot(a, b):
    """dtype operands, f32 products and sums."""
    return a.float() @ b.float()


def self_attn_step_ref(x, ln_scale, ln_bias, w_qkv, w_out, cache_k, cache_v,
                       pos: int, num_heads: int, key_pad=None):
    """The plain PyTorch version of :func:`self_attn_step`."""
    dt = x.dtype
    lmax = cache_k.shape[1]
    dh = x.shape[1] // num_heads
    xn = layernorm(x, ln_scale.float(), ln_bias.float()).to(dt)
    future = (torch.arange(lmax, device=x.device) > pos)[:, None]   # [L, 1]
    out = x
    for h in range(num_heads):
        qkv = _dot(xn, w_qkv[h])                                    # [B, 3Dh]
        q = qkv[:, :dh] * dh ** -0.5
        cache_k[h, pos] = qkv[:, dh:2 * dh].to(cache_k.dtype)
        cache_v[h, pos] = qkv[:, 2 * dh:].to(cache_v.dtype)
        s = (q[None] * cache_k[h].float()).sum(-1)                  # [L, B]
        s = s.masked_fill(future, NEG_INF)
        if key_pad is not None:
            s = s.masked_fill(key_pad != 0, PAD_FILL)
        w = torch.softmax(s, dim=0)
        ctx = (w[:, :, None] * cache_v[h].float()).sum(0)          # [B, Dh]
        out = (out.float() + _dot(ctx.to(dt), w_out[h])).to(x.dtype)
    return out, cache_k, cache_v


def cross_ffn_step_ref(x, ln_c_scale, ln_c_bias, wq_cross, ck, cv, src_pad,
                       w_out_cross, ln_f_scale, ln_f_bias, w1, b1, w2, b2,
                       num_heads: int):
    """The plain PyTorch version of :func:`cross_ffn_step`."""
    dt = x.dtype
    b, d = x.shape
    dh = d // num_heads
    xf = x.float()
    xn = layernorm(xf, ln_c_scale.float(), ln_c_bias.float())
    q = _dot(xn.to(dt), wq_cross).reshape(b, 1, num_heads, dh) * dh ** -0.5
    s = (q * ck.float()).sum(-1)                                    # [B,Tc,H]
    s = s.masked_fill(src_pad[:, :, None] != 0, NEG_INF)
    w = torch.softmax(s, dim=1)
    ctx = (w[..., None] * cv.float()).sum(1).reshape(b, d)
    xf = xf + _dot(ctx.to(dt), w_out_cross)
    xn = layernorm(xf, ln_f_scale.float(), ln_f_bias.float())
    h1 = torch.relu(_dot(xn.to(dt), w1) + b1.float())
    xf = xf + _dot(h1.to(dt), w2) + b2.float()
    return xf.to(x.dtype)


# ---------------------------------------------------------------------------
def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_tensors(what, x, shapes, f32=()):
    """Every call checks; a message is only formatted for a failed check."""
    for name, (t, shape) in shapes.items():
        want = torch.float32 if name in f32 else x.dtype
        if (t.shape == shape and t.device == x.device and t.is_contiguous()
                and t.dtype == want):
            continue
        _check(tuple(t.shape) == shape, what,
               f"{name} shape {tuple(t.shape)} != {shape}")
        _check(t.device == x.device, what, f"{name} on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), what, f"{name} is not contiguous")
        _check(t.dtype == want, what, f"{name} dtype {t.dtype} != {want}")


def _workspace(lib, fn, args, dev):
    """The f32 partial-product workspace the C side sizes for ``args``."""
    return torch.empty((fn(ctypes.byref(args)),), dtype=torch.float32,
                       device=dev)


def _run_self(lib, x, ln_scale, ln_bias, w_qkv, w_out, cache_k, cache_v, pos,
              nh, key_pad):
    from blt_vqg_tpu_torch.ops.kernels import _build

    what = "self_attn_step"
    b, d = x.shape
    _check(x.dtype in _ACT_DTYPES, what, f"activation dtype {x.dtype}")
    _check(d % nh == 0, what, f"hidden {d} not divisible by {nh} heads")
    dh = d // nh
    _check(dh % 8 == 0 and dh <= 256, what,
           f"head_dim {dh} must be a multiple of 8 and <= 256")
    lmax = cache_k.shape[1]
    _check(0 <= pos < lmax, what, f"pos {pos} outside the cache [0, {lmax})")
    _check_tensors(what, x, {
        "x": (x, (b, d)), "ln_scale": (ln_scale, (d,)),
        "ln_bias": (ln_bias, (d,)), "w_qkv": (w_qkv, (nh, d, 3 * dh)),
        "w_out": (w_out, (nh, dh, d)),
        "cache_k": (cache_k, (nh, lmax, b, dh)),
        "cache_v": (cache_v, (nh, lmax, b, dh))},
        f32=("ln_scale", "ln_bias"))
    kp_strides = (0, 0)
    if key_pad is not None:
        _check(tuple(key_pad.shape) == (lmax, b) and key_pad.dtype
               == torch.float32 and key_pad.device == x.device, what,
               f"key_pad must be f32 [{lmax}, {b}] on {x.device}")
        kp_strides = key_pad.stride()
    dev = x.device
    out = torch.empty_like(x)
    xn = torch.empty_like(x)
    qkv = torch.empty((nh, b, 3 * dh), dtype=torch.float32, device=dev)
    ctx = torch.empty((nh, b, dh), dtype=x.dtype, device=dev)
    a = _build.SelfAttnArgs(
        act_bf16=int(x.dtype == torch.bfloat16), batch=b, dim=d, heads=nh,
        head_dim=dh, lmax=lmax, pos=int(pos), kp_sl=kp_strides[0],
        kp_sb=kp_strides[1], q_scale=dh ** -0.5, x=x.data_ptr(),
        ln_scale=ln_scale.data_ptr(), ln_bias=ln_bias.data_ptr(),
        w_qkv=w_qkv.data_ptr(), w_out=w_out.data_ptr(),
        cache_k=cache_k.data_ptr(), cache_v=cache_v.data_ptr(),
        key_pad=None if key_pad is None else key_pad.data_ptr(),
        out=out.data_ptr(), xn=xn.data_ptr(), qkv=qkv.data_ptr(),
        ctx=ctx.data_ptr())
    part = _workspace(lib, lib.bvq_self_attn_workspace, a, dev)
    a.part = part.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib, lib.bvq_self_attn_step(ctypes.byref(a), stream), what)
    return out


def self_attn_step(x, ln_scale, ln_bias, w_qkv, w_out, cache_k, cache_v,
                   pos: int, num_heads: int, key_pad=None):
    """x [B, D]; ln_scale/ln_bias [D] f32; w_qkv [H, D, 3*Dh] (head-h
    column slices of the fused QKV kernel); w_out [H, Dh, D]; caches
    [H, L, B, Dh] in x's dtype, written at ``pos`` in place; ``key_pad``
    [L, B] f32 (nonzero = pad, any strides) masks pad-token keys and must
    never mark a row past ``pos``.  Returns (x + self_attention(LN(x)),
    cache_k, cache_v).

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    any problem raises.  ``self_attn_step.launches`` counts launches."""
    if x.device.type == "cpu":
        return self_attn_step_ref(x, ln_scale, ln_bias, w_qkv, w_out,
                                  cache_k, cache_v, pos, num_heads, key_pad)
    if x.device.type != "cuda":
        raise ValueError(f"self_attn_step: unsupported device {x.device}")
    from blt_vqg_tpu_torch.ops.kernels import _build

    out = _run_self(_build.library(), x, ln_scale, ln_bias, w_qkv, w_out,
                    cache_k, cache_v, int(pos), num_heads, key_pad)
    self_attn_step.launches += 1
    return out, cache_k, cache_v


self_attn_step.launches = 0


def cross_products(dim: int, ffn: int):
    """(groups, depth, width, reduce) of cross_ffn_step's four products (q,
    out, FFN in, FFN out), as csrc/decode_layer.cu's ``cross_gemms`` sets
    them up."""
    return ((1, dim, dim, 0), (1, dim, dim, 1), (1, dim, ffn, 0),
            (1, ffn, dim, 1))


def _prepare_cross(x, ln_c_scale, ln_c_bias, wq, ck, cv, src_pad, wo,
                   ln_f_scale, ln_f_bias, w1, b1, w2, b2, nh):
    """Validates the tensors and allocates the output and one scratch
    buffer; returns the kernel's arguments (``CrossFfnArgs``), the output
    and the scratch tensor."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    what = "cross_ffn_step"
    b, d = x.shape
    _check(x.dtype in _ACT_DTYPES, what, f"activation dtype {x.dtype}")
    _check(d % nh == 0, what, f"hidden {d} not divisible by {nh} heads")
    dh, tc, f = d // nh, ck.shape[1], w1.shape[1]
    _check_tensors(what, x, {
        "x": (x, (b, d)), "ln_c_scale": (ln_c_scale, (d,)),
        "ln_c_bias": (ln_c_bias, (d,)), "wq_cross": (wq, (d, d)),
        "ck": (ck, (b, tc, nh, dh)), "cv": (cv, (b, tc, nh, dh)),
        "w_out_cross": (wo, (d, d)), "ln_f_scale": (ln_f_scale, (d,)),
        "ln_f_bias": (ln_f_bias, (d,)), "w1": (w1, (d, f)), "b1": (b1, (f,)),
        "w2": (w2, (f, d)), "b2": (b2, (d,))},
        f32=("ln_c_scale", "ln_c_bias", "ln_f_scale", "ln_f_bias", "b1",
             "b2"))
    if not (src_pad.shape == (b, tc) and src_pad.dtype == torch.bool
            and src_pad.device == x.device):
        _check(False, what, f"src_pad must be bool [{b}, {tc}] on {x.device}")
    out = torch.empty_like(x)
    act = x.element_size()
    floats = gemm_workspace(b, cross_products(d, f), x.dtype == torch.bfloat16)
    buf, ptrs = scratch(x.device, dict(
        xn=b * d * act, ctx=b * d * act, x1=b * d * 4,
        h1=b * f * act, part=floats * 4))
    a = _build.CrossFfnArgs(
        act_bf16=int(x.dtype == torch.bfloat16), batch=b, dim=d, heads=nh,
        head_dim=dh, tc=tc, ffn=f, sp_sb=src_pad.stride(0),
        sp_st=src_pad.stride(1), q_scale=dh ** -0.5, x=x.data_ptr(),
        ln_c_scale=ln_c_scale.data_ptr(), ln_c_bias=ln_c_bias.data_ptr(),
        wq=wq.data_ptr(), ck=ck.data_ptr(), cv=cv.data_ptr(),
        src_pad=src_pad.data_ptr(), wo=wo.data_ptr(),
        ln_f_scale=ln_f_scale.data_ptr(), ln_f_bias=ln_f_bias.data_ptr(),
        w1=w1.data_ptr(), b1=b1.data_ptr(), w2=w2.data_ptr(),
        b2=b2.data_ptr(), out=out.data_ptr(), part_floats=floats,
        **ptrs)
    return a, out, buf


def _run_cross(lib, *args):
    from blt_vqg_tpu_torch.ops.kernels import _build

    a, out, _buf = _prepare_cross(*args)
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    _build.check(lib, lib.bvq_cross_ffn_step(ctypes.byref(a), stream),
                 "cross_ffn_step")
    return out


def cross_ffn_step(x, ln_c_scale, ln_c_bias, wq_cross, ck, cv, src_pad,
                   w_out_cross, ln_f_scale, ln_f_bias, w1, b1, w2, b2,
                   num_heads: int):
    """x [B, D]; LayerNorm scales and biases [D] f32; wq_cross and
    w_out_cross [D, D]; ck/cv [B, Tc, H, Dh] precomputed cross K/V; src_pad
    [B, Tc] bool (True = masked, any strides, e.g. a broadcast view);
    w1 [D, F], b1 [F] f32, w2 [F, D], b2 [D] f32.  Returns the layer output
    after cross attention and the FFN with their residuals.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    any problem raises.  ``cross_ffn_step.launches`` counts launches."""
    if x.device.type == "cpu":
        return cross_ffn_step_ref(x, ln_c_scale, ln_c_bias, wq_cross, ck, cv,
                                  src_pad, w_out_cross, ln_f_scale,
                                  ln_f_bias, w1, b1, w2, b2, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"cross_ffn_step: unsupported device {x.device}")
    from blt_vqg_tpu_torch.ops.kernels import _build

    out = _run_cross(_build.library(), x, ln_c_scale, ln_c_bias, wq_cross,
                     ck, cv, src_pad, w_out_cross, ln_f_scale, ln_f_bias, w1,
                     b1, w2, b2, num_heads)
    cross_ffn_step.launches += 1
    return out


cross_ffn_step.launches = 0
