"""Diagnostic builds of ``int8_wgmma_kernel`` (csrc/int8_matmul.cu), timed on
the card: where the time of a bf16 ``int8_matmul`` call goes.

Each variant copies ``blt_vqg_tpu_torch/csrc`` into ``runs/int8_diag/`` (an
ignored directory), edits the copy (a part removed, a constant changed),
adds a %globaltimer mark at each phase of a block (entry, the mbarriers
ready, the first stage landed, the last product done, the epilogue done)
and SM-cycle sums (per 64 K) of thread 0's wait for a stage, its
widening, its product issue and its wait for the products, builds it,
and
runs ``int8_matmul`` at the vocab head (M 64, K 1,024, N 12,000) and at
FFN in at beam width (M 256, K 1,024, N 2,048), with 64- and with
128-column tiles (seed-made weights, copies cycled so that they do not sit
in L2).  For each it prints the median over 5 calls of the
launch's span (the first block's entry to the last block's end, by the
marks: no profiler), for the last call the medians over the blocks, and
the first call's largest error against the plain version.
A variant that removes a part computes wrong results: it is for timing
only.

Run from the repository root on a machine with the card and nvcc:

    python3 tools/int8_diag.py [variant ...]
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from blt_vqg_tpu_torch.ops.kernels import _build  # noqa: E402
from blt_vqg_tpu_torch.ops.kernels import int8_matmul as im  # noqa: E402

SRC = "int8_matmul.cu"
LOAD_X = ("        for (int x = 0; x < I8_BK / I8_XK; ++x)\n"
          "          tma_load_2d(st + x * (I8_BM * I8_XK * 2), &xmap, &full[s], kt * I8_BK + x * I8_XK,\n"
          "                      m0);\n")
LOAD_W = ("        for (int c = 0; c < CW; ++c)\n"
          "          tma_load_2d(st + I8_X_BYTES + c * I8_W_BYTES, &wmap, &full[s], n0 + c * I8_WN,\n"
          "                      kt * I8_BK);\n")
EXPECT = "        mbar_arrive_expect_tx(&full[s], SB);\n"
WIDEN = "    i8_tile_a_frags(a, 2 * h, st + I8_X_BYTES + cw * I8_W_BYTES, h, chunk, lane);\n"
PRODUCTS = ("    wgmma_m64n64k16_rs(acc, a[j],\n"
            "                       wgmma_desc_sw128(st + (j / 4) * (I8_BM * I8_XK * 2)) + 2 * (j % 4));\n")
STAGES = "constexpr int I8_STAGES = 4;"
BK = "constexpr int I8_BK = 128;"

# variant: [(file, text, replacement)]
VARIANTS = {
    "built": [],
    "stages3": [(SRC, STAGES, STAGES.replace("4", "3"))],
    "stages6": [(SRC, STAGES, STAGES.replace("4", "6"))],
    # the first design's 64-deep stages, 6 of them
    "bk64": [(SRC, BK, BK.replace("128", "64")), (SRC, STAGES, STAGES.replace("4", "6"))],
    "no_x_loads": [(SRC, LOAD_X, ""),
                   (SRC, EXPECT, EXPECT.replace("SB", "SB - I8_X_BYTES"))],
    "no_w_loads": [(SRC, LOAD_W, ""), (SRC, EXPECT, EXPECT.replace("SB", "I8_X_BYTES"))],
    "no_loads": [(SRC, LOAD_X, ""), (SRC, LOAD_W, ""),
                 (SRC, EXPECT, EXPECT.replace("SB", "0"))],
    "no_widen": [(SRC, WIDEN, "    for (int i = 0; i < 8; ++i) a[2 * h + i / 4][i % 4] = lane + i;\n")],
    "no_products": [(SRC, PRODUCTS, "")],
}

TRACE = r"""
__device__ unsigned long long bvq_i8_trace[4096][12];
__shared__ long long i8_acc[4];  // thread 0's cycles: wait, widen, issue, product wait
__device__ __forceinline__ void i8_mark(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    bvq_i8_trace[blockIdx.x + gridDim.x * blockIdx.y][i] = t;
  }
}
"""
ROW = "bvq_i8_trace[blockIdx.x + gridDim.x * blockIdx.y]"
TRACE_SUBS = [(SRC, old, new) for old, new in [
    ("// One stage of a consumer warp", TRACE + "\n// One stage of a consumer warp"),
    ("  const int s = kt % I8_STAGES;\n  mbar_wait(&full[s], (kt / I8_STAGES) & 1);\n"
     "  __syncwarp();  // the ldmatrix and wgmma below are warp-collective\n",
     "  const int s = kt % I8_STAGES;\n  const long long c0 = clock64();\n"
     "  mbar_wait(&full[s], (kt / I8_STAGES) & 1);\n"
     "  __syncwarp();  // the ldmatrix and wgmma below are warp-collective\n"
     "  const long long c1 = clock64();\n"
     f"  if (kt == 0) {{\n    i8_mark(2);\n    if (threadIdx.x == 0) {ROW}[5] = c1;\n  }}\n"),
    ("  wgmma_fence();\n", "  const long long c2 = clock64();\n  wgmma_fence();\n"),
    ("  wgmma_commit();\n}\n",
     "  wgmma_commit();\n  if (threadIdx.x == 0) {\n    i8_acc[0] += c1 - c0;\n"
     "    i8_acc[1] += c2 - c1;\n    i8_acc[2] += clock64() - c2;\n  }\n}\n"),
    ("  const int stages = (K + I8_BK - 1) / I8_BK;\n",
     "  const int stages = (K + I8_BK - 1) / I8_BK;\n  i8_mark(0);\n"
     "  if (threadIdx.x == 0) i8_acc[0] = i8_acc[1] = i8_acc[2] = i8_acc[3] = 0;\n"),
    ("  __syncthreads();\n\n  if (warp == CONSUMERS / 32) {",
     "  __syncthreads();\n  i8_mark(1);\n\n  if (warp == CONSUMERS / 32) {"),
    ("      wgmma_wait<1>();\n",
     "      { const long long w0 = clock64(); wgmma_wait<1>();\n"
     "        if (threadIdx.x == 0) i8_acc[3] += clock64() - w0; }\n"),
    ("  wgmma_wait<0>();\n",
     f"  wgmma_wait<0>();\n  i8_mark(3);\n  if (threadIdx.x == 0) {{\n"
     f"    unsigned long long* row = {ROW};\n"
     "    row[6] = clock64();\n    for (int i = 0; i < 4; ++i) row[7 + i] = i8_acc[i];\n  }\n"),
    ("          rf_pack(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);\n  }\n}\n",
     "          rf_pack(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);\n  }\n  i8_mark(4);\n}\n"),
    ("extern \"C\" long bvq_int8_matmul_workspace",
     "extern \"C\" int bvq_i8_trace_read(void* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, bvq::bvq_i8_trace, sizeof(bvq::bvq_i8_trace));\n}\n\n"
     "extern \"C\" long bvq_int8_matmul_workspace"),
]]
SHAPES = (("vocab head", 64, 1024, 12000), ("FFN in at beam width", 256, 1024, 2048))
PHASES = ("entry -> mbarriers ready", "-> first stage landed", "-> last product done",
          "epilogue")


def build(name, subs):
    """Builds an edited copy of the sources; returns the loaded library."""
    d = os.path.join(ROOT, "runs", "int8_diag", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "blt_vqg_tpu_torch", "csrc"), d)
    for f, old, new in subs:
        path = os.path.join(d, f)
        src = open(path).read()
        if old not in src:
            raise RuntimeError(f"{name}: {f} has no {old[:60]!r}")
        open(path, "w").write(src.replace(old, new))
    _build.CSRC, _build.BUILD = d, os.path.join(d, "build")
    _build.library.cache_clear()
    lib = _build.library()
    lib.bvq_i8_trace_read.argtypes = [ctypes.c_void_p]
    return lib


def inputs(dev):
    g = torch.Generator(dev).manual_seed(0)
    out = []
    for what, m, k, n in SHAPES:
        x = (torch.randn((m, k), generator=g, device=dev) * 2).to(torch.bfloat16)
        w8, s = im.quantize_int8(torch.randn((k, n), generator=g, device=dev) * k ** -0.5)
        copies = max(1, math.ceil(60e6 / w8.numel()))
        out.append((what, x, [w8.clone() for _ in range(copies)], s))
    return out


def call(x, ws, s, bn):
    """One int8_matmul call per call of the returned function, the weight
    copies cycled, ``bn``-column tiles forced."""
    state = {"i": 0}

    def fn():
        keep = im.tma_columns
        im.tma_columns = lambda *a, **kw: bn
        try:
            return im.int8_matmul(x, ws[state["i"] % len(ws)], s)
        finally:
            im.tma_columns = keep
            state["i"] += 1
    return fn


def read(lib, blocks):
    buf = np.zeros((4096, 12), dtype=np.uint64)
    if lib.bvq_i8_trace_read(buf.ctypes.data) != 0:
        raise RuntimeError("reading the trace failed")
    return buf[:blocks].astype(np.int64)


def trace(tag, lib, cases, calls: int = 5):
    for what, x, ws, s in cases:
        for bn in (64, 128):
            fn = call(x, ws, s, bn)
            y = fn().float()
            want = im.int8_matmul_ref(x, ws[0], s).float()
            err = float((y - want).abs().max() / want.abs().max())
            blocks = -(-ws[0].shape[1] // bn) * -(-x.shape[0] // 64)
            for _ in range(3):
                fn()
            spans = []
            for _ in range(calls):
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
                t = read(lib, blocks)
                spans.append((t[:, 4].max() - t[:, 0].min()) / 1e3)
            rel = (t[:, :5] - t[:, 0].min()) / 1e3
            ph = np.diff(t[:, :5], axis=1) / 1e3
            stages = -(-x.shape[1] // 64)
            cyc = t[:, 7:11] / stages
            ns_per_cycle = (t[:, 3] - t[:, 2]) / np.maximum(t[:, 6] - t[:, 5], 1)
            print(f"{tag}: {what}, {bn}-column tiles ({blocks} blocks): max error "
                  f"{err:.3g} of max|plain|; launch span "
                  f"median {np.median(spans):.2f} us (calls {[round(v, 2) for v in spans]}); "
                  f"block entry last {rel[:, 0].max():.2f}, block life median "
                  f"{np.median(rel[:, 4] - rel[:, 0]):.2f}; phases (median / 90th "
                  f"percentile, us): " + ", ".join(
                      f"{p} {np.median(ph[:, i]):.2f} / {np.percentile(ph[:, i], 90):.2f}"
                      for i, p in enumerate(PHASES))
                  + f"; per 64 K (median SM cycles; {np.median(ns_per_cycle):.3f} ns a "
                  f"cycle): wait {np.median(cyc[:, 0]):.0f}, widen "
                  f"{np.median(cyc[:, 1]):.0f}, issue {np.median(cyc[:, 2]):.0f}, "
                  f"product wait {np.median(cyc[:, 3]):.0f}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    cases = inputs(torch.device("cuda", 0))
    for v in opts.variants:
        trace(v, build(v, TRACE_SUBS + VARIANTS[v]), cases)


if __name__ == "__main__":
    main()
