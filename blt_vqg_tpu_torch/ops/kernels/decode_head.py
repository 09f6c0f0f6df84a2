"""Fused decode head (counterpart of ``blt_vqg_tpu/ops/pallas/decode_head.py``):
final LayerNorm + vocab projection + greedy argmax, no logits stored.

:func:`head_argmax` launches the kernel of ``csrc/decode_head.cu`` on CUDA
tensors and computes the plain version :func:`head_argmax_ref` on CPU
tensors.  Ties go to the first maximal index.  The caller pads the weights
to a chunk multiple with :func:`pad_head` (zero columns, ``PAD_BIAS``
bias), so padded columns never win.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from blt_vqg_tpu_torch.ops.kernels.decode_stream import layernorm

PAD_BIAS = -1e30


def head_chunk(vocab_size: int, target: int = 1024) -> int:
    """Vocab chunk size: ``target`` (a multiple of 128) unless the vocab is
    smaller, then the smallest 128-multiple covering it."""
    return min(target, -(-vocab_size // 128) * 128)


def pad_head(w: torch.Tensor, b: torch.Tensor, chunk: int):
    """Pad [D, V] head weights and [V] bias to a multiple of ``chunk``
    along V: zero weights, ``PAD_BIAS`` bias."""
    v = w.shape[1]
    vp = -(-v // chunk) * chunk
    if vp != v:
        w = F.pad(w, (0, vp - v))
        b = F.pad(b, (0, vp - v), value=PAD_BIAS)
    return w, b


def head_logits_ref(x, ln_scale, ln_bias, w, b, scales=None) -> torch.Tensor:
    """f32 logits [B, Vp] of the fused head.  The LayerNorm output is
    rounded to ``x.dtype`` when the weights are int8 (``scales`` given),
    else to ``w.dtype``, as in the TPU kernel."""
    quantized = scales is not None
    dtype = x.dtype if quantized else w.dtype
    xn = layernorm(x, ln_scale.float(), ln_bias.float()).to(dtype)
    logits = xn.float() @ w.float()
    if quantized:
        logits = logits * scales.float()
    return logits + b.float()


def head_argmax_ref(x, ln_scale, ln_bias, w, b, *,
                    scales=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`head_argmax`."""
    logits = head_logits_ref(x, ln_scale, ln_bias, w, b, scales)
    return torch.argmax(logits, dim=-1).to(torch.int32)  # first max wins


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"head_argmax: {msg}")


def _run(lib, x, ln_scale, ln_bias, w, b, scales):
    """Validates the tensors, allocates outputs and scratch, and launches
    the two passes of csrc/decode_head.cu on the current stream."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    bsz, d = x.shape
    vp = w.shape[1]
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"activation dtype {x.dtype}")
    quantized = scales is not None
    _check(w.dtype == (torch.int8 if quantized else x.dtype),
           f"weights {w.dtype} with activations {x.dtype} "
           f"({'with' if quantized else 'without'} scales)")
    shapes = {"x": (x, (bsz, d)), "ln_scale": (ln_scale, (d,)),
              "ln_bias": (ln_bias, (d,)), "w": (w, (d, vp)), "b": (b, (vp,))}
    if quantized:
        shapes["scales"] = (scales, (1, vp))
    for name, (t, shape) in shapes.items():
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
        if name not in ("x", "w"):
            _check(t.dtype == torch.float32, f"{name} must be f32")

    # stream-ordered temporaries, as in decode_stream._run; the C side
    # sizes the workspace and lays out its partials in it
    dev = x.device
    tokens = torch.empty((bsz,), dtype=torch.int32, device=dev)
    xn = torch.empty_like(x)
    a = _build.HeadArgs(
        act_bf16=int(x.dtype == torch.bfloat16), w_i8=int(quantized),
        batch=bsz, dim=d, vocab=vp, x=x.data_ptr(),
        ln_scale=ln_scale.data_ptr(), ln_bias=ln_bias.data_ptr(),
        w=w.data_ptr(), scales=scales.data_ptr() if quantized else None,
        bias=b.data_ptr(), xn=xn.data_ptr(), tokens=tokens.data_ptr())
    part = torch.empty((lib.bvq_head_workspace(ctypes.byref(a)),),
                       dtype=torch.float32, device=dev)
    a.part = part.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib, lib.bvq_head_argmax(ctypes.byref(a), stream),
                 "head_argmax")
    return tokens


def head_argmax(x, ln_scale, ln_bias, w, b, *, chunk: int | None = None,
                scales=None) -> torch.Tensor:
    """Greedy token ids [B] int32 from a pre-final-LN decoder output.

    x [B, D] (the stack kernel's raw output); ln_scale/ln_bias [D] (the
    decoder's final LayerNorm, f32); w [D, Vp] head weights already cast to
    the activation dtype, or int8 with ``scales`` [1, Vp] f32, and padded
    with :func:`pad_head`; b [Vp] f32.  ``chunk`` must divide Vp, as in the
    TPU kernel; the CUDA kernel tiles the vocab its own way, which cannot
    change the first-index argmax.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    any problem raises.  ``head_argmax.launches`` counts launches.
    """
    vp = w.shape[1]
    if chunk is None:
        chunk = head_chunk(vp)
    _check(vp % chunk == 0, f"padded vocab {vp} is not a multiple of {chunk}")
    if x.device.type == "cpu":
        return head_argmax_ref(x, ln_scale, ln_bias, w, b, scales=scales)
    if x.device.type != "cuda":
        raise ValueError(f"head_argmax: unsupported device {x.device}")
    from blt_vqg_tpu_torch.ops.kernels import _build

    tokens = _run(_build.library(), x, ln_scale, ln_bias, w, b, scales)
    head_argmax.launches += 1
    return tokens


head_argmax.launches = 0
