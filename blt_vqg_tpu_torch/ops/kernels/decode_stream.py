"""One greedy-decode step of the whole decoder stack (counterpart of
``blt_vqg_tpu/ops/pallas/decode_stream.py``).

:func:`decode_stack_step` keeps the JAX function's argument layouts (the
stacked per-head, per-head-group and per-FFN-chunk weight slices) and
returns ``(x_out, k_new, v_new)``; the caller writes k_new/v_new into the
caches at ``pos``.  On CUDA tensors it launches the kernels of
``csrc/decode_stream.cu`` (12 a layer and one); on CPU tensors it computes the plain version
:func:`decode_stack_step_ref`.  The TPU kernel's ``bucketed_cache`` option
is a DMA schedule with no effect on the result and is not carried over.

Numerics copied from the TPU kernel, in both versions:

- q is rounded to the activation dtype, then scaled by Dh^-0.5 in it;
- k and v are rounded to the cache dtype;
- self-attention scores are dtype products summed in f32; the
  unnormalized softmax weights are rounded to dtype before the V sum;
- cached rows at index >= pos take ``FUTURE_FILL``, pad-masked keys take
  ``MASK_FILL`` above it, so an all-pad visible prefix comes out uniform;
- the residual is rounded to the activation dtype after each of the three
  phases; ``b1`` is added before the ReLU and ``b2`` with the residual;
- int8 weights apply their per-column scale to the f32 product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blt_vqg_tpu_torch.ops.masks import FUTURE_FILL, MASK_FILL

_ACT_DTYPES = (torch.float32, torch.bfloat16)


def quantize_stack(w: torch.Tensor):
    """Symmetric per-output-column int8 over the contraction axis (-2):
    [..., K, N] -> (int8 [..., K, N], f32 scales [..., 1, N]).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w8, scale


def pick_stages(num_heads: int, pwffn_dim: int) -> tuple:
    """(cross_stages, ffn_stages): the largest divisors <= 4.  They set the
    stacked layouts of the cross-attention and FFN weights."""
    hc = next(d for d in (4, 3, 2, 1) if num_heads % d == 0)
    fc = next(d for d in (4, 3, 2, 1) if pwffn_dim % d == 0)
    return hc, fc


def layernorm(x, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """f32 LayerNorm, the TPU kernel's formula."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _dot(a, b):
    """dtype (or int8) operands, f32 products and sums."""
    return a.float() @ b.float()


def _oscale(y, s):
    return y if s is None else y * s


@functools.lru_cache(maxsize=None)
def _q_scale(head_dim: int, dtype) -> float:
    return float(scaled_q_scale(head_dim, dtype))


def scaled_q_scale(head_dim: int, dtype) -> torch.Tensor:
    """Dh^-0.5 as a 0-dim tensor of ``dtype``: the TPU kernel multiplies a
    dtype array by a weakly typed Python float, which rounds it to dtype."""
    return torch.tensor(head_dim ** -0.5, dtype=dtype)


def decode_stack_step_ref(x, pos, lns, wqkv, wout, cache_k, cache_v,
                          wqc, woc, ckc, cvc, smask, w1, b1, w2, b2, *,
                          num_heads: int, cross_stages: int, ffn_stages: int,
                          weight_scales=None, key_pad=None, key_pad_cur=None):
    """The plain PyTorch version of :func:`decode_stack_step`."""
    nl, nh = wqkv.shape[0], wqkv.shape[1]
    hc, fc = cross_stages, ffn_stages
    b, d = x.shape
    dh = d // nh
    hpc = nh // hc
    tc = ckc.shape[2]
    lmax = cache_k.shape[2]
    dt = x.dtype
    s6 = (None,) * 6 if weight_scales is None else tuple(weight_scales)
    sc = lambda i, l, j: None if s6[i] is None else s6[i][l, j]
    scale = scaled_q_scale(dh, dt)
    stale = (torch.arange(lmax, device=x.device) >= pos)[:, None]  # [Lmax,1]
    k_new = torch.empty((nl, nh, b, dh), dtype=cache_k.dtype, device=x.device)
    v_new = torch.empty((nl, nh, b, dh), dtype=cache_v.dtype, device=x.device)

    for l in range(nl):
        # ---- self-attention, one head at a time
        xn = layernorm(x, lns[l, 0], lns[l, 1]).to(dt)
        acc = x.float()
        for h in range(nh):
            qkv = _oscale(_dot(xn, wqkv[l, h]), sc(0, l, h))
            q = qkv[:, :dh].to(dt) * scale
            k = qkv[:, dh:2 * dh].to(cache_k.dtype)
            v = qkv[:, 2 * dh:].to(cache_v.dtype)
            k_new[l, h], v_new[l, h] = k, v
            kc, vc = cache_k[l, h], cache_v[l, h]              # [Lmax,B,Dh]
            s_cache = (q[None] * kc).float().sum(-1)           # [Lmax, B]
            s_cache = s_cache.masked_fill(stale, FUTURE_FILL)
            s_cur = (q * k).float().sum(-1)                    # [B]
            if key_pad is not None:
                s_cache = s_cache.masked_fill((key_pad != 0) & ~stale,
                                              MASK_FILL)
                s_cur = s_cur.masked_fill(key_pad_cur[0] != 0, MASK_FILL)
            m = torch.maximum(s_cache.amax(0), s_cur)
            e_cache = torch.exp(s_cache - m[None])
            e_cur = torch.exp(s_cur - m)
            den = e_cache.sum(0) + e_cur
            ctx = ((e_cache[:, :, None].to(dt) * vc).float().sum(0)
                   + e_cur[:, None] * v.float()) / den[:, None]
            acc = acc + _oscale(_dot(ctx.to(dt), wout[l, h]), sc(1, l, h))
        x = acc.to(x.dtype)

        # ---- cross-attention, one head group at a time
        xn = layernorm(x, lns[l, 2], lns[l, 3]).to(dt)
        acc = x.float()
        for j in range(hc):
            q = _oscale(_dot(xn, wqc[l, j]), sc(2, l, j))
            q = (q.to(dt) * scale).float().reshape(b, hpc, dh)
            ck = ckc[l, j].float().reshape(tc, b, hpc, dh)
            s = (q[None] * ck).sum(-1)                         # [Tc,B,hpc]
            s = s.masked_fill(smask[:, :, None] != 0, MASK_FILL)
            w = torch.softmax(s, dim=0)
            cv = cvc[l, j].float().reshape(tc, b, hpc, dh)
            ctx = (w[..., None] * cv).sum(0).reshape(b, hpc * dh)
            acc = acc + _oscale(_dot(ctx.to(dt), woc[l, j]), sc(3, l, j))
        x = acc.to(x.dtype)

        # ---- FFN, one chunk of the hidden width at a time
        xn = layernorm(x, lns[l, 4], lns[l, 5]).to(dt)
        acc = x.float() + b2[l, 0]
        for c in range(fc):
            h1 = _oscale(_dot(xn, w1[l, c]), sc(4, l, c)) + b1[l, c, 0]
            h1 = torch.relu(h1)
            acc = acc + _oscale(_dot(h1.to(dt), w2[l, c]), sc(5, l, c))
        x = acc.to(x.dtype)
    return x, k_new, v_new


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_stack_step: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


# common.cuh's split-K product: [GEMM_TILE, GEMM_TILE] output tiles, the
# depth split in parts of 256 rows (bf16 activations) or 128 (f32)
GEMM_TILE = 64


def gemm_splits(depth: int, bf16: bool) -> int:
    return -(-depth // (256 if bf16 else 128))


def gemm_workspace(batch: int, products, bf16: bool) -> int:
    """The f32 partials that the largest of ``products`` ((groups, depth,
    width, reduce), ...) needs in the split-K product's workspace
    (common.cuh ``gemm_partial_floats``): one [row tiles, column tiles]
    grid of whole tiles per (group, K split)."""
    tiles = lambda a: -(-a // GEMM_TILE)
    return max(g * gemm_splits(k, bf16) * tiles(batch) * tiles(n)
               * GEMM_TILE ** 2 for g, k, n, _ in products)


def stack_products(dim: int, heads: int, hc: int, fc: int, ffn: int):
    """(groups, depth, width, reduce) of the step's six products (QKV, out,
    cross q, cross out, FFN in, FFN out), as csrc/decode_stream.cu's
    ``layer_gemms`` sets them up."""
    dh = dim // heads
    w, fch = (heads // hc) * dh, ffn // fc
    return ((heads, dim, 3 * dh, 0), (heads, dh, dim, 1), (hc, dim, w, 0),
            (hc, w, dim, 1), (fc, dim, fch, 0), (fc, fch, dim, 1))


def scratch(dev, pieces: dict):
    """One allocation for ``pieces`` ({name: bytes}), each at a 256-byte
    boundary; returns the tensor and {name: its pointer}.  From PyTorch's
    caching allocator on the current stream, where the kernels run, so
    dropping it once they are queued is safe: its memory only goes to work
    queued later on that stream."""
    offsets, total = {}, 0
    for name, size in pieces.items():
        offsets[name] = total
        total += -(-size // 256) * 256
    buf = torch.empty((total,), dtype=torch.uint8, device=dev)
    return buf, {k: buf.data_ptr() + o for k, o in offsets.items()}


def _prepare(x, pos, lns, weights, scales, cache_k, cache_v, ckc, cvc,
             smask, b1, b2, key_pad, key_pad_cur, hc, fc):
    """Validates the tensors and allocates the outputs and one scratch
    buffer; returns the kernel's arguments (``StackArgs``), the outputs
    (x_out, k_new, v_new) and the scratch tensor."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    wqkv, wout, wqc, woc, w1, w2 = weights
    nl, nh = wqkv.shape[0], wqkv.shape[1]
    b, d = x.shape
    dt = x.dtype
    _check(dt in _ACT_DTYPES, f"activation dtype {dt} not in {_ACT_DTYPES}")
    _check(d % nh == 0, f"hidden {d} not divisible by {nh} heads")
    dh = d // nh
    _check(dh % 8 == 0 and dh <= 256,
           f"head_dim {dh} must be a multiple of 8 and <= 256")
    _check(nh % hc == 0, f"{nh} heads not divisible by {hc} cross stages")
    hpc, lmax, tc = nh // hc, cache_k.shape[2], ckc.shape[2]
    f = w1.shape[1] * w1.shape[3]
    fch = f // fc
    _check(0 <= pos < lmax, f"pos {pos} outside the cache [0, {lmax})")
    shapes = {
        "x": (x, (b, d)), "lns": (lns, (nl, 6, d)),
        "wqkv": (wqkv, (nl, nh, d, 3 * dh)), "wout": (wout, (nl, nh, dh, d)),
        "cache_k": (cache_k, (nl, nh, lmax, b, dh)),
        "cache_v": (cache_v, (nl, nh, lmax, b, dh)),
        "wqc": (wqc, (nl, hc, d, hpc * dh)), "woc": (woc, (nl, hc, hpc * dh, d)),
        "ckc": (ckc, (nl, hc, tc, b, hpc * dh)),
        "cvc": (cvc, (nl, hc, tc, b, hpc * dh)), "smask": (smask, (tc, b)),
        "w1": (w1, (nl, fc, d, fch)), "b1": (b1, (nl, fc, 1, fch)),
        "w2": (w2, (nl, fc, fch, d)), "b2": (b2, (nl, 1, d)),
    }
    if key_pad is not None:
        shapes["key_pad"] = (key_pad, (lmax, b))
        shapes["key_pad_cur"] = (key_pad_cur, (1, b))
    # every call checks; a message is only formatted for a failed check
    dev = x.device
    for name, (t, shape) in shapes.items():
        if t.shape != shape or t.device != dev or not t.is_contiguous():
            _check(tuple(t.shape) == shape,
                   f"{name} shape {tuple(t.shape)} != {shape}")
            _check(t.device == dev, f"{name} on {t.device}, x on {dev}")
            _check(t.is_contiguous(), f"{name} is not contiguous")
    for name in ("lns", "b1", "b2") + (("key_pad", "key_pad_cur")
                                       if key_pad is not None else ()):
        if shapes[name][0].dtype != torch.float32:
            _check(False, f"{name} must be f32")
    _check(smask.dtype == torch.int32, "smask must be int32")
    for name in ("cache_k", "cache_v", "ckc", "cvc"):
        if shapes[name][0].dtype != dt:
            _check(False, f"{name} dtype must be {dt}")
    names = ("wqkv", "wout", "wqc", "woc", "w1", "w2")
    w_i8 = []
    for name, w, s in zip(names, weights, scales):
        if s is None:
            if w.dtype != dt:
                _check(False, f"{name} dtype {w.dtype} != {dt}")
        else:
            sshape = tuple(w.shape[:-2]) + (1, w.shape[-1])
            if not (w.dtype == torch.int8 and s.dtype == torch.float32
                    and s.shape == sshape and s.is_contiguous()
                    and s.device == dev):
                _check(w.dtype == torch.int8,
                       f"{name} has scales but is {w.dtype}")
                _check(False, f"{name} scales must be contiguous f32 {sshape}")
        w_i8.append(int(s is not None))

    x_out = torch.empty_like(x)
    k_new = torch.empty((nl, nh, b, dh), dtype=dt, device=dev)
    v_new = torch.empty((nl, nh, b, dh), dtype=dt, device=dev)
    act = x.element_size()
    floats = gemm_workspace(
        b, stack_products(d, nh, hc, fc, f), dt == torch.bfloat16)
    buf, ptrs = scratch(dev, dict(
        xn=b * d * act, ctx=nh * b * dh * act, ctxc=hc * b * hpc * dh * act,
        h1=fc * b * fch * act, part=floats * 4))
    a = _build.StackArgs(
        act_bf16=int(dt == torch.bfloat16), batch=b, dim=d, layers=nl,
        heads=nh, head_dim=dh, lmax=lmax, pos=int(pos), tc=tc, hc=hc, fc=fc,
        ffn=f, w_i8=(ctypes.c_int * 6)(*w_i8),
        q_scale=_q_scale(dh, dt),
        x=x.data_ptr(), lns=lns.data_ptr(),
        w=(ctypes.c_void_p * 6)(*[w.data_ptr() for w in weights]),
        s=(ctypes.c_void_p * 6)(*[_ptr(s) for s in scales]),
        cache_k=cache_k.data_ptr(), cache_v=cache_v.data_ptr(),
        ckc=ckc.data_ptr(), cvc=cvc.data_ptr(), smask=smask.data_ptr(),
        b1=b1.data_ptr(), b2=b2.data_ptr(), key_pad=_ptr(key_pad),
        key_pad_cur=_ptr(key_pad_cur), x_out=x_out.data_ptr(),
        k_new=k_new.data_ptr(), v_new=v_new.data_ptr(), part_floats=floats,
        **ptrs)
    return a, (x_out, k_new, v_new), buf


def _run(lib, *args):
    """Launches the kernels of csrc/decode_stream.cu on the current stream
    (arguments as :func:`_prepare`'s)."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    a, out, _buf = _prepare(*args)
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    _build.check(lib, lib.bvq_decode_stack_step(ctypes.byref(a), stream),
                 "decode_stack_step")
    return out


def decode_stack_step(x, pos, lns, wqkv, wout, cache_k, cache_v,
                      wqc, woc, ckc, cvc, smask, w1, b1, w2, b2, *,
                      num_heads: int, cross_stages: int, ffn_stages: int,
                      weight_scales=None, key_pad=None, key_pad_cur=None):
    """One whole-stack decode step.

    x [B, D]; pos the position being decoded; caches [L, H, Lmax, B, Dh]
    (read only: position ``pos`` comes from the in-flight K/V);
    lns [L, 6, D] f32 (self/cross/FFN LayerNorm scale and bias);
    wqkv [L, H, D, 3*Dh]; wout [L, H, Dh, D]; wqc [L, Hc, D, (H/Hc)*Dh];
    woc [L, Hc, (H/Hc)*Dh, D]; ckc/cvc [L, Hc, Tc, B, (H/Hc)*Dh];
    smask [Tc, B] int32 (1 = masked); w1 [L, Fc, D, F/Fc];
    b1 [L, Fc, 1, F/Fc] f32; w2 [L, Fc, F/Fc, D]; b2 [L, 1, D] f32.
    ``weight_scales`` is None or a 6-tuple (wqkv, wout, wqc, woc, w1, w2)
    whose entries are None (that kind in the activation dtype) or the f32
    [..., 1, N] scales of an int8 kind from :func:`quantize_stack`.
    ``key_pad`` [Lmax, B] f32 (nonzero = pad) with ``key_pad_cur`` [1, B]
    masks pad-token keys.  Returns (x_out [B, D], k_new [L, H, B, Dh],
    v_new [L, H, B, Dh]).

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    any problem raises.  ``decode_stack_step.launches`` counts launches.
    """
    if x.device.type == "cpu":
        return decode_stack_step_ref(
            x, pos, lns, wqkv, wout, cache_k, cache_v, wqc, woc, ckc, cvc,
            smask, w1, b1, w2, b2, num_heads=num_heads,
            cross_stages=cross_stages, ffn_stages=ffn_stages,
            weight_scales=weight_scales, key_pad=key_pad,
            key_pad_cur=key_pad_cur)
    if x.device.type != "cuda":
        raise ValueError(f"decode_stack_step: unsupported device {x.device}")
    from blt_vqg_tpu_torch.ops.kernels import _build

    _check(wqkv.shape[1] == num_heads, "num_heads does not match wqkv")
    _check(wqc.shape[1] == cross_stages and w1.shape[1] == ffn_stages,
           "stage counts do not match the stacked weights")
    _check((key_pad is None) == (key_pad_cur is None),
           "key_pad and key_pad_cur go together")
    scales = (None,) * 6 if weight_scales is None else tuple(weight_scales)
    _check(len(scales) == 6, "weight_scales must have 6 entries")
    out = _run(_build.library(), x, int(pos), lns,
               (wqkv, wout, wqc, woc, w1, w2), scales, cache_k, cache_v,
               ckc, cvc, smask, b1, b2, key_pad, key_pad_cur, cross_stages,
               ffn_stages)
    decode_stack_step.launches += 1
    return out


decode_stack_step.launches = 0
