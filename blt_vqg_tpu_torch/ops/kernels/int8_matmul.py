"""W8A16 product (counterpart of ``blt_vqg_tpu/ops/pallas/int8_matmul.py``):
``y [M, N] = (x [M, K] @ w8 [K, N]) * scale [N]``.

:func:`int8_matmul` launches the kernel of ``csrc/int8_matmul.cu`` on CUDA
tensors and computes the plain version :func:`int8_matmul_ref` on CPU
tensors.  Both apply the scale to the f32-accumulated product, as the TPU
kernel does, and round the result to x's dtype.  Any N works.
:func:`tma_columns` decides, from the dtype, the shapes and the
addresses, which kernel a call takes: bf16 calls that TMA can load run
one ``int8_wgmma_kernel`` launch with no workspace; the others run the
split-K product (partials, then an epilogue).
:func:`quantize_int8` is the JAX function's symmetric per-output-channel
scheme, the port's ``decode_stream.quantize_stack`` on a [K, N] matrix.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blt_vqg_tpu_torch.ops.kernels.decode_stream import quantize_stack


def quantize_int8(w: torch.Tensor):
    """w [K, N] float -> (w8 [K, N] int8, scale [N] f32), w ~ w8 * scale."""
    w8, scale = quantize_stack(w)
    return w8, scale[0]


def int8_matmul_ref(x: torch.Tensor, w8: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`int8_matmul`."""
    return ((x.float() @ w8.float()) * scale.float()).to(x.dtype)


def tma_columns(dtype: torch.dtype, m: int, k: int, n: int,
                aligned: bool = True, sms: int = 132) -> int:
    """Weight columns of an ``int8_wgmma_kernel`` block (64 or 128) for a
    call, or 0 where the split-K product takes it: f32 activations (an f32
    product), or strides and addresses TMA cannot load (x's row K * 2
    bytes and w8's row N bytes multiples of 16, both 16-byte ``aligned``).
    128 where 128-column tiles of 64 x rows still give two thirds of the
    ``sms`` blocks, else 64."""
    if dtype != torch.bfloat16 or m < 1 or k % 8 or n % 16 or not aligned:
        return 0
    tiles = -(-n // 128) * -(-m // 64)
    return 128 if 3 * tiles >= 2 * sms else 64


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_matmul: {msg}")


def int8_matmul(x: torch.Tensor, w8: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or f32) @ dequant(w8 [K, N] int8, scale [N] f32) ->
    [M, N] in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    any problem raises.  ``int8_matmul.launches`` counts launches."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    from blt_vqg_tpu_torch.ops.kernels import _build

    m, k = x.shape
    n = w8.shape[1]
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"activation dtype {x.dtype}")
    for name, t, shape, dtype in (("x", x, (m, k), x.dtype),
                                  ("w8", w8, (k, n), torch.int8),
                                  ("scale", scale, (n,), torch.float32)):
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        _check(t.dtype == dtype, f"{name} dtype {t.dtype} != {dtype}")
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    lib = _build.library()
    bn = tma_columns(x.dtype, m, k, n,
                     x.data_ptr() % 16 == 0 and w8.data_ptr() % 16 == 0,
                     _sms(x.device.index or 0))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    a = _build.Int8Args(act_bf16=int(x.dtype == torch.bfloat16), m=m, k=k,
                        n=n, bn=bn, x=x.data_ptr(), w8=w8.data_ptr(),
                        scale=scale.data_ptr(), y=y.data_ptr())
    if not bn:
        part = torch.empty((lib.bvq_int8_matmul_workspace(ctypes.byref(a)),),
                           dtype=torch.float32, device=x.device)
        a.part = part.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, lib.bvq_int8_matmul(ctypes.byref(a), stream),
                 "int8_matmul")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0
