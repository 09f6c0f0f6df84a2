"""Diagnostic builds of the cluster split-K product (csrc/common.cuh) and the
kernels on it, timed on the card: where the time of the bf16
``head_argmax`` and ``self_attn_step`` goes.

Each variant copies ``blt_vqg_tpu_torch/csrc`` into ``runs/cluster_diag/``
(an ignored directory), edits the copy (a part removed, a constant
changed), builds it, and times the head (int8 and bf16 weights, b64, D
1,024, Vp 12,288; seed-made weights) and ``self_attn_step`` (b64 and b256,
8 heads, Dh 128, pos 25, six weight sets cycled) by profiler device time,
split by kernel.  A variant that removes a part computes wrong results: it is for
timing only.  ``--trace`` builds the sources with a %globaltimer mark at
each phase of the head's cluster kernel (entry, the first chunk landed,
the product done, the cluster barrier, the epilogue, the last barrier) and
prints the medians over the blocks, warm and cold L2, at 2 and 4 ranks.

Run from the repository root on a machine with the card and nvcc:

    python3 tools/cluster_diag.py [--trace] [variant ...]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from blt_vqg_tpu_torch.ops.kernels import _build  # noqa: E402
from blt_vqg_tpu_torch.ops.kernels import decode_head as dh  # noqa: E402
from blt_vqg_tpu_torch.ops.kernels import decode_layer as dl  # noqa: E402
from blt_vqg_tpu_torch.ops.kernels import decode_stream as ds  # noqa: E402

STAGES = "CK_KS = 64, CK_STAGES = 3;"
LOAD_X = ("        rf_load16(xs + m * CK_XLD + k, xg + (size_t)m * p.xs_b + kc + k,\n"
          "                  m < live ? max(0, min(8, kn - k)) : 0, zero);\n")
LOAD_W = ("        rf_load16(ws + k * WLD + n, wg + (size_t)(kc + k) * p.N + n,\n"
          "                  k < kn ? max(0, min(E, p.N - n0 - n)) : 0, wzero);\n")


def _cut_epilogue():
    """Returns after the first cluster barrier (no epilogue, no last
    barrier): the product and the barrier alone."""
    return [("decode_layer.cu", "  cluster.sync();\n  constexpr int S4",
             "  cluster.sync();\n  if (C > 0) return;\n  constexpr int S4"),
            ("decode_layer.cu", "  cluster.sync();\n#pragma unroll\n  for (int j = 0; j < ITEMS; ++j) {\n    const int it = threadIdx.x + j * CK_THREADS, row = it / S4;\n    const int col = (rank * S4 + it % S4) * 4, b = m0 + row, n = n0 + col;\n    if (b >= p.B || n >= N) continue;",
             "  cluster.sync();\n  if (C > 0) return;\n#pragma unroll\n  for (int j = 0; j < ITEMS; ++j) {\n    const int it = threadIdx.x + j * CK_THREADS, row = it / S4;\n    const int col = (rank * S4 + it % S4) * 4, b = m0 + row, n = n0 + col;\n    if (b >= p.B || n >= N) continue;"),
            ("decode_head.cu", "  cluster.sync();\n#pragma unroll\n  for (int j = 0; j < ITEMS; ++j) {",
             "  cluster.sync();\n  if (C > 0) return;\n#pragma unroll\n  for (int j = 0; j < ITEMS; ++j) {")]


# variant: [(file, text, replacement)]
VARIANTS = {
    "built": [],
    "stages2": [("common.cuh", STAGES, STAGES.replace("= 3", "= 2"))],
    "stages4": [("common.cuh", STAGES, STAGES.replace("= 3", "= 4"))],
    "no_x_loads": [("common.cuh", LOAD_X, "")],
    "no_w_loads": [("common.cuh", LOAD_W, "")],
    "no_loads": [("common.cuh", LOAD_X, ""), ("common.cuh", LOAD_W, "")],
    "no_epilogue": _cut_epilogue(),
}
# plan variants on the built sources: (what, module, name, function)
PLANS = (
    ("head on 4 ranks of 256", dh, "cluster_split", lambda d, t, s: (4, 256)),
    ("QKV on 2 ranks of 512", dl, "cluster_split", lambda d, t, s: (2, 512)),
    ("out on 4 ranks of 2 heads", dl, "cluster_heads", lambda h: (4, 2)),
)

TRACE = r'''
__device__ unsigned long long bvq_trace[16384][8];
__device__ __forceinline__ void bvq_mark(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    bvq_trace[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][i] = t;
  }
}
'''
TRACE_SUBS = [
    ("common.cuh", "namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n" + TRACE),
    ("common.cuh", "      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage\n",
     "      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage\n"
     "      if (c == 0) bvq_mark(1);\n"),
    ("common.cuh", "    float* pt = part + (size_t)i * CK_BM * CK_PLD;\n",
     "    bvq_mark(2);\n    float* pt = part + (size_t)i * CK_BM * CK_PLD;\n"),
    ("decode_head.cu", "  const int rank = cluster.block_rank(), pairs = gridDim.x;\n",
     "  const int rank = cluster.block_rank(), pairs = gridDim.x;\n  bvq_mark(0);\n"),
    ("decode_head.cu", "  cluster.sync();\n#pragma unroll\n  for (int j = 0; j < ITEMS; ++j) {",
     "  bvq_mark(3);\n  cluster.sync();\n  bvq_mark(4);\n#pragma unroll\n  for (int j = 0; j < ITEMS; ++j) {"),
    ("decode_head.cu", "  cluster.sync();  // the peers have read this block's partials\n}\n\ntemplate <bool I8>",
     "  bvq_mark(5);\n  cluster.sync();  // the peers have read this block's partials\n  bvq_mark(6);\n}\n\ntemplate <bool I8>"),
    ("decode_head.cu", "}  // namespace bvq\n",
     "}  // namespace bvq\nextern \"C\" int bvq_trace_read(void* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, bvq::bvq_trace, sizeof(bvq::bvq_trace));\n}\n"),
]
PHASES = ("entry -> first chunk", "first chunk -> product", "product -> barrier",
          "barrier", "epilogue", "last barrier")


def build(name, subs):
    """Builds an edited copy of the sources; returns the loaded library."""
    d = os.path.join(ROOT, "runs", "cluster_diag", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "blt_vqg_tpu_torch", "csrc"), d)
    for f, old, new in subs:
        path = os.path.join(d, f)
        src = open(path).read()
        if old not in src:
            raise RuntimeError(f"{name}: {f} has no {old[:50]!r}")
        open(path, "w").write(src.replace(old, new))
    _build.CSRC, _build.BUILD = d, os.path.join(d, "build")
    _build.library.cache_clear()
    return _build.library()


def inputs(dev):
    g = torch.Generator(dev).manual_seed(0)
    rnd = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    b, d, v, h, dh_, lmax = 64, 1024, 12288, 8, 128, 51
    x = rnd(b, d, sc=2).to(torch.bfloat16)
    ln = (1 + rnd(d, sc=0.1), rnd(d, sc=0.1))
    w8, s8 = ds.quantize_stack(rnd(d, v, sc=d ** -0.5))
    wb, bias = rnd(d, v, sc=d ** -0.5).to(torch.bfloat16), rnd(v)
    heads = {"head int8": lambda: dh.head_argmax(x, *ln, w8, bias, scales=s8),
             "head bf16": lambda: dh.head_argmax(x, *ln, wb, bias)}
    steps = {}
    for bt in (64, 256):
        xb = rnd(bt, d, sc=2).to(torch.bfloat16)
        sets = [(rnd(h, d, 3 * dh_, sc=d ** -0.5).to(torch.bfloat16),
                 rnd(h, dh_, d, sc=d ** -0.5).to(torch.bfloat16),
                 rnd(h, lmax, bt, dh_).to(torch.bfloat16),
                 rnd(h, lmax, bt, dh_).to(torch.bfloat16)) for _ in range(6)]
        state = {"i": 0}

        def step(xb=xb, sets=sets, state=state):
            s = sets[state["i"] % len(sets)]
            state["i"] += 1
            return dl.self_attn_step(xb, *ln, *s, 25, h)
        steps[f"self_attn_step b{bt}"] = step
    return heads, steps


def kernel_us(fn, calls: int = 6) -> dict:
    """{kernel: us per launch} by profiler over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            name = e.key.split("(")[0].split("<")[0].split("::")[-1]
            us = getattr(e, "self_device_time_total", 0.0) or e.self_cuda_time_total
            out[name] = round(us / e.count, 2)
    return out


def time_all(tag, heads, steps):
    for what, fn in (*heads.items(), *steps.items()):
        print(f"{tag}: {what}: {kernel_us(fn)}", flush=True)


def trace(heads, dev):
    lib = build("trace", TRACE_SUBS)
    flush = torch.empty(32 << 20, device=dev)
    for split in ((2, 512), (4, 256)):
        dh.cluster_split = lambda d, t, s, split=split: split
        for what, fn in heads.items():
            for cold in (False, True):
                for _ in range(3):
                    fn()
                if cold:
                    flush.add_(1.0)
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
                buf = np.zeros((16384, 8), dtype=np.uint64)
                if lib.bvq_trace_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
                    raise RuntimeError("reading the trace failed")
                t = buf[:192 * split[0], :7].astype(np.int64)
                rel = (t - t[:, 0].min()) / 1e3
                ph = np.diff(t, axis=1) / 1e3
                print(f"trace {what} {split[0]} ranks of {split[1]}, L2 "
                      f"{'cold' if cold else 'warm'}: launch {rel[:, 6].max():.2f}"
                      f" us; block entry median {np.median(rel[:, 0]):.2f}, "
                      f"last {rel[:, 0].max():.2f}; block life median "
                      f"{np.median(rel[:, 6] - rel[:, 0]):.2f}; phases (median"
                      f" / 90th percentile, us): " + ", ".join(
                          f"{n} {np.median(ph[:, i]):.2f} / "
                          f"{np.percentile(ph[:, i], 90):.2f}"
                          for i, n in enumerate(PHASES)), flush=True)
    dh.cluster_split = ds.cluster_split


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--trace", action="store_true")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    dev = torch.device("cuda", 0)
    heads, steps = inputs(dev)
    for v in opts.variants:
        build(v, VARIANTS[v])
        time_all(v, heads, steps)
        if v == "built":
            for what, mod, name, fn in PLANS:
                keep = getattr(mod, name)
                setattr(mod, name, fn)
                time_all(f"built, {what}", heads, steps)
                setattr(mod, name, keep)
    if opts.trace:
        trace(heads, dev)


if __name__ == "__main__":
    main()
