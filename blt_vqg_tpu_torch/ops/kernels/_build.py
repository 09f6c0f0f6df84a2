"""Builds the CUDA sources of ``blt_vqg_tpu_torch/csrc`` and loads them.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a``, one
process per file, all started together, and linked into one shared library
with a plain C interface, at first use, under
``blt_vqg_tpu_torch/build/`` with a name keyed by a hash of the sources and
flags (a changed source builds a new library).  The library is loaded with
``ctypes``; every C entry point returns a ``cudaError_t`` and :func:`check`
raises on anything but 0.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_long
F = ctypes.c_float


class StackArgs(ctypes.Structure):
    """Mirror of ``bvq::StackArgs`` in csrc/decode_stream.cu."""
    _fields_ = [("act_bf16", I), ("batch", I), ("dim", I), ("layers", I),
                ("heads", I), ("head_dim", I), ("lmax", I), ("pos", I),
                ("tc", I), ("hc", I), ("fc", I), ("ffn", I),
                ("w_i8", I * 6), ("q_scale", F),
                ("x", P), ("lns", P), ("w", P * 6), ("s", P * 6),
                ("cache_k", P), ("cache_v", P), ("ckc", P), ("cvc", P),
                ("smask", P), ("b1", P), ("b2", P), ("key_pad", P),
                ("key_pad_cur", P), ("x_out", P), ("k_new", P), ("v_new", P),
                ("xn", P), ("ctx", P), ("ctxc", P), ("h1", P), ("part", P),
                ("part_floats", L)]


class HeadArgs(ctypes.Structure):
    """Mirror of ``bvq::HeadArgs`` in csrc/decode_head.cu."""
    _fields_ = [("act_bf16", I), ("w_i8", I), ("batch", I), ("dim", I),
                ("vocab", I), ("cluster", I), ("kslice", I), ("x", P),
                ("ln_scale", P), ("ln_bias", P), ("w", P), ("scales", P),
                ("bias", P), ("xn", P), ("part", P), ("part_floats", L),
                ("tokens", P)]


class FlashGeom(ctypes.Structure):
    """Mirror of ``bvq::FlashGeom`` in csrc/flash_attention.cu."""
    _fields_ = [(f, I) for f in ("wq", "groups", "kt", "dp", "lds", "fixed",
                                 "stage", "nst", "smem", "grid_x", "grid_y")]


class FlashArgs(ctypes.Structure):
    """Mirror of ``bvq::FlashArgs`` in csrc/flash_attention.cu."""
    _fields_ = [("act_bf16", I), ("causal", I), ("batch", I), ("heads", I),
                ("tq", I), ("tk", I), ("dim", I), ("q", P), ("k", P),
                ("v", P), ("kv_pad", P), ("o", P), ("m", P), ("l", P),
                ("dout", P), ("delta", P), ("dq", P), ("dk", P), ("dv", P)]


class FlashCall(ctypes.Structure):
    """Mirror of ``bvq::FlashCall`` in csrc/flash_attention.cu: what the
    flash entry points take."""
    _fields_ = [("a", FlashArgs), ("geom", FlashGeom)]


RING_MAX_RANKS = 64     # RING_RMAX in csrc/ring_attention.cu


class RingStep(ctypes.Structure):
    """Mirror of ``bvq::RingStep`` in csrc/ring_attention.cu."""
    _fields_ = [("nent", I), ("npair", I), ("rank", I * RING_MAX_RANKS),
                ("info", I * RING_MAX_RANKS),
                ("src", I * (2 * RING_MAX_RANKS)),
                ("pair", I * (2 * RING_MAX_RANKS))]


class RingFwdArgs(ctypes.Structure):
    """Mirror of ``bvq::RingFwdArgs`` in csrc/ring_attention.cu."""
    _fields_ = [("act_bf16", I), ("causal", I), ("batch", I), ("heads", I),
                ("chunk", I), ("dim", I), ("rs", L), ("sb", L),
                ("slot_rs", L), ("q", P), ("acc", P), ("m", P), ("l", P),
                ("o", P), ("k", P * 2), ("v", P * 2), ("pad", P * 2),
                ("step", RingStep)]


class RingBwdArgs(ctypes.Structure):
    """Mirror of ``bvq::RingBwdArgs`` in csrc/ring_attention.cu."""
    _fields_ = [("act_bf16", I), ("causal", I), ("ranks", I), ("batch", I),
                ("heads", I), ("chunk", I), ("dim", I), ("rs", L), ("sb", L),
                ("slot_rs", L), ("q", P), ("dout", P), ("m", P), ("l", P),
                ("delta", P), ("dq", P), ("k", P * 2), ("v", P * 2),
                ("pad", P * 2), ("rider", P * 2), ("dq_out", P), ("dk", P),
                ("dv", P), ("ret", P * 2), ("step", RingStep)]


class SelfAttnArgs(ctypes.Structure):
    """Mirror of ``bvq::SelfAttnArgs`` in csrc/decode_layer.cu."""
    _fields_ = [("act_bf16", I), ("batch", I), ("dim", I), ("heads", I),
                ("head_dim", I), ("lmax", I), ("pos", I), ("qkv_cluster", I),
                ("qkv_kslice", I), ("out_cluster", I), ("out_heads", I),
                ("kp_sl", L), ("kp_sb", L), ("q_scale", F), ("x", P),
                ("ln_scale", P), ("ln_bias", P), ("w_qkv", P), ("w_out", P),
                ("cache_k", P), ("cache_v", P), ("key_pad", P), ("out", P),
                ("xn", P), ("qkv", P), ("ctx", P), ("part", P),
                ("part_floats", L)]


class CrossFfnArgs(ctypes.Structure):
    """Mirror of ``bvq::CrossFfnArgs`` in csrc/decode_layer.cu."""
    _fields_ = [("act_bf16", I), ("batch", I), ("dim", I), ("heads", I),
                ("head_dim", I), ("tc", I), ("ffn", I), ("sp_sb", L),
                ("sp_st", L), ("q_scale", F), ("x", P), ("ln_c_scale", P),
                ("ln_c_bias", P), ("wq", P), ("ck", P), ("cv", P),
                ("src_pad", P), ("wo", P), ("ln_f_scale", P),
                ("ln_f_bias", P), ("w1", P), ("b1", P), ("w2", P), ("b2", P),
                ("out", P), ("xn", P), ("ctx", P), ("x1", P), ("h1", P),
                ("part", P), ("part_floats", L)]


class Int8Args(ctypes.Structure):
    """Mirror of ``bvq::Int8Args`` in csrc/int8_matmul.cu."""
    _fields_ = [("act_bf16", I), ("m", I), ("k", I), ("n", I), ("bn", I),
                ("x", P), ("w8", P), ("scale", P), ("y", P), ("part", P)]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    return os.path.join(BUILD, f"libbvq_kernels_{h.hexdigest()[:16]}.so")


def _run(cmds):
    """Runs the commands side by side; returns their output, in order, or
    raises with the first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")
    return outs


def build() -> str:
    """Compiles the library if it is not built yet; returns its path.  The
    compiler's report (registers, spills) is kept beside it as ``.log``."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    srcs = sources()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    try:
        report = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
                       for src, obj in zip(srcs, objs)])
        report += _run([[_nvcc(), *ARCH, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(out + ".log", "w") as f:
        f.write("".join(report))
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    lib.bvq_decode_stack_step.argtypes = [ctypes.POINTER(StackArgs), P]
    lib.bvq_decode_stack_step.restype = I
    lib.bvq_head_argmax.argtypes = [ctypes.POINTER(HeadArgs), P]
    lib.bvq_head_argmax.restype = I
    for name in ("bvq_flash_fwd", "bvq_flash_bwd_dkdv", "bvq_flash_bwd_dq"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(FlashCall), P]
        fn.restype = I
    lib.bvq_ring_fwd_step.argtypes = [ctypes.POINTER(RingFwdArgs), P]
    lib.bvq_ring_fwd_step.restype = I
    for name in ("bvq_ring_bwd_dkdv", "bvq_ring_bwd_dq", "bvq_ring_land"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(RingBwdArgs), P]
        fn.restype = I
    for name, args in (("bvq_cross_ffn_step", CrossFfnArgs),
                       ("bvq_self_attn_step", SelfAttnArgs),
                       ("bvq_int8_matmul", Int8Args)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(args), P]
        fn.restype = I
    lib.bvq_int8_matmul_workspace.argtypes = [ctypes.POINTER(Int8Args)]
    lib.bvq_int8_matmul_workspace.restype = L
    lib.bvq_error_string.argtypes = [I]
    lib.bvq_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.bvq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
