"""Drives the PyTorch port's serving and training paths on one CUDA card
and checks the hand-written kernels they run.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; the last line is printed
only when every phase passed):

0. the card (``nvidia-smi`` name and power limit) and the versions;
1. builds the kernels from ``blt_vqg_tpu_torch/csrc`` (one nvcc per
   source, all started together, at first use);
2. holds each kernel against its plain PyTorch version at the flagship
   shapes in bf16, on the same CUDA tensors, the stack step also at b128
   and b512 (bf16 and int8 weights), and checks by profiler that a stack
   call runs its launch sequence (12 kernels a layer and one) and a head
   call its 3 kernels, and nothing else;
3. serves 3 request rounds of batch 64 through ``blt_vqg_tpu_torch.serve``
   at the flagship configuration (streaming stack, int8 fused head) with
   seed-made weights, checks the tokens and that each kernel launched 51
   times per round, serves one more round under the profiler (one self-
   and one cross-attention kernel a layer per stack call), and replays
   one round step by step against the plain versions;
4. times decode questions/s at batch 64 on the kernel path and on the
   port's plain decode path, and each kernel against its plain version
   (the stack step and the head by events and by profiler device time,
   the head also with a cold L2);
5. holds the three flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions in bf16 at the four attention shapes of the
   flagship train step, at a causal multi-tile shape with unaligned
   padding, at a shape with dead rows, at a ragged causal shape (Tq
   33, Tk 65, head dim 80, B*H 6), at 16 queries against 1,024 keys
   (many key tiles through two stages) and at one key with a dead batch
   row, and checks that the plain version without its key-pad mask fails
   the check;
6. trains the flagship configuration with ``use_pallas_attention`` and no
   attention dropout (batch 64, seed-made weights): 3 pretrain steps, the
   optimizer reset, 3 latent steps and an eval step, checking the losses
   and the exact flash launch counts, and runs the same steps on the
   port's einsum attention path from the same weights, batch and
   generator seeds, holding loss, gradient norm and parameters to limits;
7. times train samples/s on both paths and the device time of a train
   step by profiler (by flash kernel: the bf16 step must run the three
   tensor-core kernels and no FMA one), and each flash kernel, by events
   and by profiler, against its plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the four training shapes and the causal multi-tile shape;
8. holds the per-layer decode kernels (``self_attn_step``,
   ``cross_ffn_step``) against their plain versions with the flagship's
   own weights, bf16, at B 64 and B 256, pos 0, 25 and 50, with and
   without a pad-key mask, under a source mask that pads one context
   column and masks one row fully (outputs and the written cache rows),
   checks by profiler that a ``cross_ffn_step`` call runs its 9 kernels
   and a bf16 ``self_attn_step`` call its 4, and nothing else, and checks
   that the plain
   ``cross_ffn_step`` without its source mask fails the check;
9. drives the per-layer decode path (``use_pallas_decode``) through
   ``make_decode_step`` and ``make_beam_decode_step``: one greedy b64
   decode and one beam decode at b64 x 4 beams, each with exactly 306
   launches of each kernel (51 steps x 6 layers; the greedy decode once
   more under the profiler: one cross-attention kernel per
   ``cross_ffn_step`` call and one self-attention kernel per
   ``self_attn_step`` call), a teacher-forced replay
   of the greedy decode holding every kernel call against its plain
   version, and a sampled decode with ``top_k=1`` that must emit the
   greedy tokens;
10. launches ``int8_matmul`` at the vocab-head shape (M 64, K 1024,
   N 12,000) and at FFN-in at beam width (M 256, K 1024, N 2048) with the
   flagship's own weights quantized, holds it against its plain version,
   checks by profiler that a call at each shape runs the TMA + wgmma
   kernel (``int8_wgmma_kernel``) alone, one launch and no workspace, and
   checks that the plain version with wrong scales fails the check;
11. times decode and beam questions/s on the per-layer path against the
   plain path, each per-layer kernel at b64 and b256 (pos 25) and
   ``int8_matmul`` at both shapes against their plain versions, bounds
   and, for ``int8_matmul`` (events and profiler device time at both
   shapes), ``torch._weight_int8pack_mm`` (a yardstick the port never
   calls);
12. holds the four ring-attention functions (one-way and two-way, forward
   and backward: o, m, l, dq, dk, dv) against their plain versions in bf16
   at the flagship's attention shapes on rings of 4, 3, 2 and 8 ranks
   (causal with target pads, non-causal, dead rows) and at a long causal
   sequence (B 2, T 4096 on 4 ranks, 10% trailing pads), once at a ragged
   65-row chunk (with and without dead rows) and at head dim 80, the
   two-way ring against full attention, and checks that the plain version
   without its key-pad mask fails the check;
13. trains the flagship with ``sequence_parallel`` on a ``seq`` 4 mesh
   (``ring_attention_impl="pallas"``, ``use_pallas_attention``, no
   attention dropout): 3 pretrain steps, the reset, 3 latent steps and an
   eval step against the einsum path from the same weights, batch and
   generator seeds, with the exact ring and flash launch counts derived
   from the schedule; then an eval step on a ``seq`` 3 mesh, where the
   posterior and context encoders ring on an odd ring;
14. times the sequence-parallel train step (and its busy share by
   profiler) against the einsum path, and each ring function at the
   training and the long shape (event time, and device time by profiler)
   against its plain version, its bound and
   ``scaled_dot_product_attention`` forward and backward (a yardstick the
   port never calls); the ``kernels`` line carries both shapes.

Phase 1 also prints the compiler's registers, shared memory and spills
of the ring and flash kernels, of the decode kernels' split-K product
and residual + LayerNorm (``gemm_partial_kernel``,
``residual_ln_kernel``), of the cluster split-K product's kernels
(``qkv_cluster_kernel``, ``out_cluster_kernel``, ``head_cluster_kernel``)
and the kernels beside them, and of ``int8_wgmma_kernel``, and checks that
the machine code of the bf16 ring kernels (the forward, the backward's
dK/dV and dQ), of the three bf16 flash kernels (forward, dK/dV, dQ), of the
three cluster kernels and of ``int8_wgmma_kernel`` runs on the tensor
cores (HMMA or HGMMA instructions, by ``cuobjdump -sass``; HGMMA, the
warpgroup product, for ``int8_wgmma_kernel``), the flash, cluster and
int8 kernels without spills.

``--flash-times-only``, ``--decode-times-only`` and ``--int8-times-only``
build, take only the flash kernels' (phase 7), the decode kernels' (the
stack step, the fused head, also with a cold L2, ``self_attn_step`` and
``cross_ffn_step``) or ``int8_matmul``'s times at both of its shapes (by
events, host clock and profiler) and stop without a result line: to
compare two trees on one card, run the same script from each tree in
turns.

TF32 is off for matmuls and cuDNN throughout.  The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import time

import numpy as np
import torch

from blt_vqg_tpu_torch import serve
from blt_vqg_tpu_torch.models.iq import IQ, PAD, START
from blt_vqg_tpu_torch.ops.kernels import (_build, decode_head, decode_layer,
                                           decode_stream)
from blt_vqg_tpu_torch.ops.kernels import int8_matmul as i8mm
from blt_vqg_tpu_torch.ops.kernels import flash_attention as fa
from blt_vqg_tpu_torch.ops.kernels import ring_attention as ra
from blt_vqg_tpu_torch.ops.layers import cast_to_compute_dtype_
from blt_vqg_tpu_torch.parallel import build_mesh
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import (make_batch, make_beam_decode_step,
                                          make_decode_step, make_eval_step,
                                          make_train_step)

BATCH, ROUNDS, SEED = 64, 3, 0
POSITIONS = (0, 1, 25, 50)
STACK_SRC = "blt_vqg_tpu_torch/csrc/decode_stream.cu"
HEAD_SRC = "blt_vqg_tpu_torch/csrc/decode_head.cu"
STACK_TPU = "blt_vqg_tpu/ops/pallas/decode_stream.py:379"
HEAD_TPU = "blt_vqg_tpu/ops/pallas/decode_head.py:114"
# x_out and k/v of the stack step: every LayerNorm output and residual is
# rounded to bf16 (18 phases: 6 layers x 3) after f32 sums taken in another
# order than the plain version's, so one-ulp flips of bf16 inputs propagate
# through the products.  Readings at flagship shapes over 6 seeds (20
# fixed-position cases and a 51-step replay each, 1,134 outputs; NVIDIA H100
# 80GB HBM3, 700 W): max error up to 4 bf16 ulps of max|plain| (99th
# percentile 3), relative norm error up to 0.0056.  The plain version with
# int8 weights against the kernel with bf16 weights reads 0.011-0.016 and
# fails the norm limit; without its last layer it reads 47-120 ulps.
STACK_MAX_ULPS = 8.0     # max |kernel - plain| / bf16 ulp of max |plain|
STACK_REL_NORM = 8e-3    # ||kernel - plain|| / ||plain||
HEAD_TOL = 1e-3          # token logit within 1e-3 * max|logit| of the max
# the device kernels of one cross_ffn_step call and of one decode_stack_step
# call (csrc/decode_layer.cu, csrc/decode_stream.cu): the products'
# partials, the attention kernels (which sum their q, k, v from the
# partials), the residual epilogues fused with the LayerNorm after them
# and the epilogues that stand alone; one LayerNorm launch first
CROSS_KERNELS = {"layernorm_kernel": 1, "gemm_partial_kernel": 4,
                 "layer_cross_attn_kernel": 1, "residual_ln_kernel": 1,
                 "gemm_epilogue_kernel": 1, "residual_epilogue_kernel": 1}
# the bf16 self_attn_step and fused head on the cluster split-K product
# (csrc/common.cuh): 4 and 3 kernels a call, no f32 partials stored
SELF_KERNELS = {"layernorm_kernel": 1, "qkv_cluster_kernel": 1,
                "self_attn_warp_kernel": 1, "out_cluster_kernel": 1}
HEAD_KERNELS = {"layernorm_kernel": 1, "head_cluster_kernel": 1,
                "head_pick_kernel": 1}
# the cluster product's kernels and the attention kernel beside them: ptxas
# registers, spills and (the product's) tensor-core SASS in phase 1
CLUSTER_MMA = ("qkv_cluster_kernel", "out_cluster_kernel",
               "head_cluster_kernel")
CLUSTER_OTHER = ("self_attn_warp_kernel", "head_pick_kernel")
# bytes written between two cold-L2 head calls (the L2 holds 50 MB; a served
# step streams the stack's 126 MB of weights between two head calls)
L2_FLUSH_BYTES = 128 << 20


def stack_kernels(layers: int) -> dict:
    """12 a layer and one: the last layer's FFN out has no LayerNorm after
    it, so its epilogue is a gemm_epilogue_kernel."""
    return {"layernorm_kernel": 1, "gemm_partial_kernel": 6 * layers,
            "self_attn_kernel": layers, "cross_attn_kernel": layers,
            "residual_ln_kernel": 3 * layers - 1,
            "gemm_epilogue_kernel": layers + 1}
# stack batches checked beside b64 (phase 2): b128 and b512 (ROADMAP queue 1)
STACK_BATCHES = (128, 512)

FLASH_SRC = "blt_vqg_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = {"flash_attention_fwd": "blt_vqg_tpu/ops/pallas/flash_attention.py:45",
             "flash_attention_bwd_dkdv":
                 "blt_vqg_tpu/ops/pallas/flash_attention.py:110",
             "flash_attention_bwd_dq":
                 "blt_vqg_tpu/ops/pallas/flash_attention.py:169"}
FLASH_KERNELS = tuple(FLASH_TPU)
# the attention calls of one flagship latent train step (B 64, H 8, Dh 128):
# (what, Tq, Tk, causal, calls per step)
FLASH_SHAPES = (("context encoder", 3, 3, False, 6),
                ("posterior encoder", 21, 21, False, 6),
                ("decoder self-attention", 20, 20, True, 6),
                ("decoder cross-attention", 20, 3, False, 6))
# (what, (B, H, Dh, Tq, Tk, causal), pads): checked in phase 5 beside the
# training shapes; the first is also timed in phase 7
FLASH_MULTI_TILE = ("multi-tile B 8 H 8 T 512 causal, scattered pads",
                    (8, 8, 128, 512, 512, True), "random")
FLASH_EXTRA_CASES = (
    FLASH_MULTI_TILE,
    ("ragged Tq 130 Tk 77, dead rows", (4, 8, 64, 130, 77, False), "dead"),
    ("ragged geometry B 3 H 2 Tq 33 Tk 65 causal Dh 80, scattered pads",
     (3, 2, 80, 33, 65, True), "random"),
    ("Tq 16 Tk 1024, two stages, many key tiles",
     (8, 8, 128, 16, 1024, False), "tail"),
    ("Tq 20 Tk 1, dead batch row", (BATCH, 8, 128, 20, 1, False), "dead"))
# the device kernels of the three flash functions in bf16 (FLASH_KERNELS'
# order), which must run on the tensor cores, and the f32 FMA kernels,
# which a bf16 train step must not reach
FLASH_MMA = ("flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
             "flash_bwd_dq_mma_kernel")
FLASH_FMA = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
             "flash_bwd_dq_kernel")
FLASH_STEP_KERNELS = FLASH_MMA + FLASH_FMA
# o, dq, dk, dv are bf16: the kernel and the plain version round p and every
# output to bf16 after f32 sums taken in other orders.  Readings over 8
# seeds x 6 cases (48; NVIDIA H100 80GB HBM3, 700 W): max error up to 1
# bf16 ulp of max|plain| (0.5 or less in 47), relative norm error up to
# 1.13e-3 (the 512-long causal case; 1.7e-5 at the training shapes), m and
# l up to 1.82e-7.  The plain version without its key-pad mask reads 132
# ulps and 0.79.
FLASH_MAX_ULPS = 2.0     # max |kernel - plain| / bf16 ulp of max |plain|
FLASH_REL_NORM = 2e-3    # ||kernel - plain|| / ||plain||
FLASH_ML_REL = 4e-7      # m and l (f32) on live rows, relative max error
# one key (Tk 1): the softmax is constant, so dq and dk are zero but for the
# f32 rounding of dp - delta, which both versions read as noise; they are
# held to that rounding's bound over D 128 products, D^2 2^-24 ~ 1e-3 of
# max|dO| max|v|, times max|k| (dq) or max|q| (dk)
FLASH_ONE_KEY_REL = 1e-3
# launches of the training phase: 3 pretrain steps (6 context + 12 decoder
# attention calls each), 3 latent steps (+6 posterior) and a latent eval
# step (forward only)
TRAIN_LAUNCHES = {"flash_attention_fwd": 3 * 18 + 3 * 24 + 24,
                  "flash_attention_bwd_dkdv": 3 * 18 + 3 * 24,
                  "flash_attention_bwd_dq": 3 * 18 + 3 * 24}
# kernel path against the einsum path after each train step and the eval
# step (bf16 compute; the two round the attention weights at different
# places, and Adam turns small gradient differences into sign flips of
# small updates).  Readings over 4 weight/batch seeds x 7 steps (NVIDIA H100
# 80GB HBM3, 700 W): loss up to 5.56e-5 relative, grad_norm 1.33e-3,
# parameters 0.159 of their motion.
TRAIN_LOSS_REL = 1.2e-4
TRAIN_GNORM_REL = 3e-3
TRAIN_PARAM_REL = 0.25   # ||theta_k - theta_e|| / ||theta_e - theta_0||
LAYER_SRC = "blt_vqg_tpu_torch/csrc/decode_layer.cu"
LAYER_TPU = {"self_attn_step": "blt_vqg_tpu/ops/pallas/decode_layer.py:118",
             "cross_ffn_step": "blt_vqg_tpu/ops/pallas/decode_layer.py:211"}
LAYER_KERNELS = tuple(LAYER_TPU)
# the device kernels of csrc/decode_layer.cu, as the profiler names them
LAYER_KERNEL_NAMES = ("gemm_partial", "gemm_epilogue", "residual_epilogue",
                      "residual_ln", "layer_self_attn", "layer_cross_attn",
                      "qkv_cluster", "self_attn_warp", "out_cluster",
                      "layernorm")
LAYER_BATCHES = (64, 256)            # greedy b64; beam b64 x 4
LAYER_POSITIONS = (0, 25, 50)
LAYER_TIME_POS = 25                  # the timed calls' decode position
BEAM = 4
# outputs and written cache rows of the per-layer kernels, bf16: the kernel
# and the plain version round the same values to bf16 after f32 sums taken
# in other orders (per head, the residual after each head).  Readings at
# flagship widths over 8 input seeds (576 self_attn_step and 96
# cross_ffn_step calls: B 64 and 256, 6 layers, pos 0/25/50, key_pad on and
# off) and two 306-call replays (NVIDIA H100 80GB HBM3, 700 W): max error up
# to 1 bf16 ulp of max|plain|, relative norm error up to 6.4e-4 (replay;
# 2.7e-4 self, 4.4e-4 cross at the fixed cases).  The plain cross_ffn_step
# without its source mask reads 104 ulps and 0.446.
LAYER_MAX_ULPS = 2.0
LAYER_REL_NORM = 2e-3
INT8_SRC = "blt_vqg_tpu_torch/csrc/int8_matmul.cu"
INT8_TPU = "blt_vqg_tpu/ops/pallas/int8_matmul.py:55"
# (what, M, K, N): the vocab head at b64 (a ragged N) and FFN-in at beam width
INT8_SHAPES = (("vocab head", 64, 1024, 12000),
               ("FFN in at beam width", 256, 1024, 2048))
# one rounding of an f32 sum taken in another order.  Readings over 8 input
# seeds at both shapes (NVIDIA H100 80GB HBM3, 700 W): max error up to 0.5
# bf16 ulp of max|plain|, relative norm error up to 2.7e-5; the plain
# version with its scales shifted by one column reads 64 ulps and 0.136.
INT8_MAX_ULPS = 1.0
INT8_REL_NORM = 1e-4
# bf16 calls at both shapes: the TMA + wgmma kernel alone (ptxas and
# HGMMA checked in phase 1)
INT8_KERNEL = "int8_wgmma_kernel"
RING_SRC = "blt_vqg_tpu_torch/csrc/ring_attention.cu"
RING_TPU = {
    "ring_attention_fwd_shard": "blt_vqg_tpu/ops/pallas/ring_attention.py:186",
    "ring_attention_fwd_bidir_shard":
        "blt_vqg_tpu/ops/pallas/ring_attention.py:373",
    "ring_attention_bwd_shard": "blt_vqg_tpu/ops/pallas/ring_attention.py:573",
    "ring_attention_bwd_bidir_shard":
        "blt_vqg_tpu/ops/pallas/ring_attention.py:815"}
RING_KERNELS = tuple(RING_TPU)
RING_SEQ = 4          # the slice's mesh: the decoder's T 20 rings on 4 ranks
# (what, B, ranks, chunk, causal, pads): the flagship's attentions on the
# slice's meshes (H 8, Dh 128), other ring sizes, dead rows, a long sequence
RING_CASES = (
    ("decoder self-attention T 20 on seq 4, causal, target pads",
     BATCH, 4, 5, True, "tail"),
    ("posterior encoder T 21 on seq 3, pads", BATCH, 3, 7, False, "tail"),
    ("context encoder T 3 on seq 3", BATCH, 3, 1, False, "none"),
    ("T 20 on seq 2, causal, pads", BATCH, 2, 10, True, "tail"),
    ("T 24 on seq 8, causal, pads", BATCH, 8, 3, True, "tail"),
    ("dead rows: T 20 on seq 4, causal, key 0 padded, batch row 1 all "
     "padded", 8, 4, 5, True, "dead"),
    ("long: T 4096 on seq 4, causal, 10% trailing pads", 2, 4, 1024, True,
     "long"))
RING_TRAIN_CASE, RING_LONG_CASE = RING_CASES[0], RING_CASES[-1]
# (what, B, ranks, chunk, causal, pads, head dim), checked at one seed: a
# ragged 64-row tile, a head dim that is not a power of two, and dead rows
# before a causal key tile (the backward's dK/dV may skip a query tile
# wholly before its keys only when no row there is dead)
RING_SHAPE_CASES = (
    ("chunk 65: T 260 on seq 4, causal, pads", 4, 4, 65, True, "tail", 128),
    ("head dim 80: T 20 on seq 4, causal, target pads", BATCH, 4, 5, True,
     "tail", 80),
    ("dead rows at chunk 65: T 260 on seq 4, causal, key 0 padded, batch row"
     " 1 all padded", 4, 4, 65, True, "dead", 128))
# the ring kernels by name (device time by kernel in phase 14)
RING_KERNEL_NAMES = ("ring_fwd_", "ring_bwd_dkdv_", "ring_bwd_dq_",
                     "ring_land_")
# the bf16 ring kernels, which must run on the tensor cores
RING_MMA = ("ring_fwd_mma_kernel", "ring_bwd_dkdv_mma_kernel",
            "ring_bwd_dq_mma_kernel")
# o, dq, dk, dv are bf16; the kernels and the plain versions round p and
# every output to bf16 after f32 sums taken in other orders (the kernels
# per 64-key tile, the plain versions per block), as the flash kernels do.
# Readings over 8 seeds x 7 cases, both schedules (NVIDIA H100 80GB HBM3,
# 700 W): max error up to 0.5 bf16 ulp of max|plain|, relative norm error
# up to 1.48e-3 (the long case, the same in every seed; 1.3e-4 at the
# others), m and l up to 3.74e-7.  The plain version without its key-pad
# mask reads 132 ulps and 0.793.
RING_MAX_ULPS = 2.0      # max |kernel - plain| / bf16 ulp of max |plain|
RING_REL_NORM = 2e-3     # ||kernel - plain|| / ||plain||
RING_ML_REL = 1e-6       # m (live rows) and l, f32, relative max error
RING_FULL_REL = 1e-5     # f32 two-way ring against full attention
# phase 13: the ring path against the einsum path after each train step and
# the eval steps (bf16; the two round the attention weights at different
# places).  Readings over 4 weight/batch seeds (NVIDIA H100 80GB HBM3,
# 700 W): loss up to 7.0e-5 relative in the train steps and the seq 4 eval
# step and 1.35e-4 in the seq 3 eval step (the posterior and context
# encoders ring there), grad_norm 1.69e-3, parameters 0.160 of their motion.
SP_LOSS_REL = 2.5e-4
SP_GNORM_REL = 3e-3
SP_PARAM_REL = 0.25
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12   # dense bf16 tensor-core peak


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi: not found"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
def stack_args(plan, x, caches, quantized: bool, key_pad=None, pos=0):
    """Arguments of decode_stack_step from a decode plan (bf16 stacks, or
    the same stacks quantized to int8 on every kind)."""
    prep = plan["stream"]
    stacks, scales = prep["stacks"], prep["scales"]
    if quantized:
        stacks, scales = zip(*[decode_stream.quantize_stack(w)
                               for w in stacks])
        stacks = tuple(w.contiguous() for w in stacks)
        scales = tuple(s.contiguous() for s in scales)
    wqkv, wout, wqc, woc, w1, w2 = stacks
    kp = kp_cur = None
    if key_pad is not None:
        kp = key_pad.float().T.contiguous()
        kp_cur = kp[pos:pos + 1].contiguous()
    args = (x, pos, prep["lns"], wqkv, wout, caches[0], caches[1], wqc, woc,
            prep["ckc"], prep["cvc"], prep["smask"], w1, prep["b1"], w2,
            prep["b2"])
    nh = wqkv.shape[1]
    kw = dict(num_heads=nh, cross_stages=wqc.shape[1],
              ffn_stages=w1.shape[1], weight_scales=scales, key_pad=kp,
              key_pad_cur=kp_cur)
    return args, kw


def stack_batch_args(plan, b: int, lmax: int, quantized: bool, pos: int,
                     seed: int, dev):
    """Arguments of decode_stack_step at batch ``b`` with the plan's weight
    stacks: seed-made bf16 x, caches and cross K/V (scale 2), a source
    mask that pads every third row's last key, and pad-key marks (key 0
    always marked)."""
    prep = plan["stream"]
    nl, nh, _, three_dh = prep["stacks"][0].shape
    dh = three_dh // 3
    _, hc, tc, _, w = prep["ckc"].shape
    g = torch.Generator(dev).manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 2.0).to(
            torch.bfloat16)

    smask = torch.zeros((tc, b), dtype=torch.int32, device=dev)
    smask[tc - 1, ::3] = 1
    key_pad = torch.rand((b, lmax), generator=g, device=dev) < 0.3
    key_pad[:, 0] = True
    caches = (rnd(nl, nh, lmax, b, dh), rnd(nl, nh, lmax, b, dh))
    stream = dict(prep, ckc=rnd(nl, hc, tc, b, w), cvc=rnd(nl, hc, tc, b, w),
                  smask=smask)
    return stack_args({"stream": stream}, rnd(b, nh * dh), caches, quantized,
                      key_pad, pos)


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 values at magnitude v > 0 (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def stack_errors(got, want):
    """(max error in bf16 ulps of max|plain|, relative norm error), the
    worst over the outputs given; inf where the kernel's are not finite."""
    worst_ulps = worst_norm = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not bool(torch.isfinite(g).all()):
            return math.inf, math.inf
        err = (g - w).abs()
        worst_ulps = max(worst_ulps, float(err.max())
                         / bf16_ulp(float(w.abs().max().clamp_min(1e-30))))
        worst_norm = max(worst_norm, float(err.norm()
                                           / w.norm().clamp_min(1e-30)))
    return worst_ulps, worst_norm


def check_close(got, want, what: str, max_ulps: float, rel_norm: float):
    """Raises unless the outputs are within the limits (bf16 ulps of
    max|plain|, relative norm error); returns (max abs error, ulps, norm)."""
    ulps, norm = stack_errors(got, want)
    if not (ulps <= max_ulps and norm <= rel_norm):
        raise AssertionError(f"{what}: max err {ulps:.3g} bf16 ulps, rel "
                             f"norm err {norm:.3g}")
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    return err, ulps, norm


def check_stack(got, want, what: str):
    """Raises unless the kernel's (x_out, k_new, v_new) are within the
    stated tolerances of the plain version's.  Returns (max |x_out err|,
    the worst max error in ulps and relative norm error of the three)."""
    _, ulps, norm = check_close(got, want, f"decode_stack_step {what}",
                                STACK_MAX_ULPS, STACK_REL_NORM)
    x_err = float((got[0].float() - want[0].float()).abs().max())
    return x_err, ulps, norm


def without_last_layer(args, kw):
    """decode_stack_step arguments of the same stack with its last layer
    left out (every per-layer stack cut by one)."""
    per_layer = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13, 14, 15)
    args = tuple(a[:-1].contiguous() if i in per_layer else a
                 for i, a in enumerate(args))
    scales = kw["weight_scales"]
    if scales is not None:
        scales = tuple(None if s is None else s[:-1].contiguous()
                       for s in scales)
    return args, dict(kw, weight_scales=scales)


def check_head(tokens, logits, what: str) -> float:
    """Raises unless every token's plain logit is within HEAD_TOL *
    max|logit| of the row maximum; returns the largest shortfall."""
    top = logits.max(dim=-1).values
    picked = logits.gather(1, tokens.long()[:, None])[:, 0]
    short = float((top - picked).max())
    if short > HEAD_TOL * float(logits.abs().max()):
        raise AssertionError(f"head_argmax {what}: token logit {short:.3g} "
                             f"below the max")
    return short


def head_args(model, quantized: bool):
    """(w, b, scales, chunk, ln_scale, ln_bias) of the fused head, int8 or
    in the compute dtype."""
    if quantized:
        return model.fused_head()
    w = model.output_proj.weight.float().T
    chunk = decode_head.head_chunk(w.shape[1])
    wp, bp = decode_head.pad_head(w.to(model.dtype),
                                  model.output_proj.bias.float(), chunk)
    ln = model.decoder.final_ln
    return {"w": wp.contiguous(), "b": bp.contiguous(), "scales": None,
            "chunk": chunk, "ln_scale": ln.weight.float().contiguous(),
            "ln_bias": ln.bias.float().contiguous()}


def run_head(h, x, kernel: bool):
    args = (x, h["ln_scale"], h["ln_bias"], h["w"], h["b"])
    if kernel:
        return decode_head.head_argmax(*args, chunk=h["chunk"],
                                       scales=h["scales"])
    return decode_head.head_argmax_ref(*args, scales=h["scales"])


def head_logits(h, x):
    return decode_head.head_logits_ref(x, h["ln_scale"], h["ln_bias"],
                                       h["w"], h["b"], h["scales"])


def cold_ms(fn, flush, calls: int):
    """(ms by events, device ms by profiler) per call of ``fn`` with the L2
    cold: ``flush`` (more bytes than the L2 holds) is written before each
    call, the events around the call alone, the device time that of the
    port's kernels (``bvq::``) alone."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(calls):
        flush.add_(1.0)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    ev = sum(a.elapsed_time(b) for a, b in pairs) / calls

    def flushed():
        flush.add_(1.0)
        fn()
    groups = profile_groups(flushed, calls)
    dev = sum(t for name, (_, t) in groups.items() if "bvq::" in name)
    return ev, dev


def bound(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it) for work that moves
    ``nbytes`` and does ``flops`` bf16 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stack_bound(args, kw, pos: int):
    """Bytes and operations one decode_stack_step call needs: every weight,
    bias, LayerNorm and cross K/V once, the cache rows below ``pos``, x in
    and x, k, v out."""
    caches = (args[5], args[6])
    nbytes = sum(t.numel() * t.element_size() for i, t in enumerate(args)
                 if isinstance(t, torch.Tensor) and i not in (5, 6))
    nbytes += sum(c.numel() * c.element_size() * pos / c.shape[2]
                  for c in caches)
    x = args[0]   # x_out [B, D] and k_new, v_new [L, H, B, Dh] written
    nbytes += x.numel() * x.element_size() * (1 + 2 * args[3].shape[0])
    scales = kw["weight_scales"] or ()
    nbytes += sum(t.numel() * 4 for t in scales if t is not None)
    b = args[0].shape[0]
    weights = sum(args[i].numel() for i in (3, 4, 7, 8, 12, 14))
    nl, nh, _, _, dh = caches[0].shape
    attn = 4 * b * nl * nh * dh * (pos + 1 + args[9].shape[2])
    return nbytes, 2 * b * weights + attn


def head_bound(h, x):
    nbytes = sum(t.numel() * t.element_size() for t in
                 (x, h["w"], h["b"], h["ln_scale"], h["ln_bias"])
                 if t is not None)
    if h["scales"] is not None:
        nbytes += h["scales"].numel() * 4
    nbytes += x.shape[0] * 4
    return nbytes, 2 * x.shape[0] * h["w"].shape[0] * h["w"].shape[1]


# ---------------------------------------------------------------------------
# flash attention

def flash_inputs(dev, b, h, d, tq, tk, causal, seed, pad="tail"):
    """bf16 q (scaled), k, v, dO and a key-pad mask: trailing pads of
    random lengths ("tail"), scattered keys ("random"), or "random" with
    every key of batch row 1 masked ("dead")."""
    g = torch.Generator(dev).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    q = (n(b, tq, h, d) * d ** -0.5).to(torch.bfloat16)
    k, v = n(b, tk, h, d).to(torch.bfloat16), n(b, tk, h, d).to(torch.bfloat16)
    do = n(b, tq, h, d).to(torch.bfloat16)
    if pad == "tail":
        lengths = torch.randint(1, tk + 1, (b,), generator=g, device=dev)
        kv_pad = torch.arange(tk, device=dev)[None, :] >= lengths[:, None]
    else:
        kv_pad = torch.rand((b, tk), generator=g, device=dev) < 0.3
        kv_pad[:, 0] = False
        if pad == "dead":
            kv_pad[1] = True
    return q, k, v, kv_pad.contiguous(), do


def flash_visible_pairs(kv_pad, tq, causal) -> int:
    """(query, key) pairs the data needs, summed over the batch rows."""
    tk = kv_pad.shape[1]
    vis = ~kv_pad[:, None, :].expand(-1, tq, tk)
    if causal:
        vis = vis & ~torch.ones((tq, tk), dtype=torch.bool,
                                device=kv_pad.device).triu(1)
    return int(vis.sum())


def flash_bounds(q, k, kv_pad, causal):
    """{kernel: (bytes, operations)} of one call each at this shape."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    pairs = flash_visible_pairs(kv_pad, tq, causal) * h
    act_q, act_k = b * tq * h * d * 2, b * tk * h * d * 2
    rows = b * h * tq * 4
    pad = kv_pad.numel()
    return {"flash_attention_fwd": (2 * act_q + 2 * act_k + 2 * rows + pad,
                                    4 * pairs * d),
            "flash_attention_bwd_dkdv": (2 * act_q + 4 * act_k + 3 * rows
                                         + pad, 8 * pairs * d),
            "flash_attention_bwd_dq": (3 * act_q + 2 * act_k + 3 * rows
                                       + pad, 6 * pairs * d)}


def rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def check_flash_case(q, k, v, kv_pad, do, causal, what: str):
    """Runs the three kernels and the plain versions on the same tensors;
    raises unless every output is within the limits.  Returns ({kernel:
    max abs error of its own outputs: o; dk and dv; dq}, worst ulps, worst
    norm error, worst m/l error)."""
    got = fa.flash_attention_fwd(q, k, v, kv_pad, causal)
    want = fa.flash_attention_fwd_ref(q, k, v, kv_pad, causal)
    o, m, l = want
    delta = fa.row_delta(do, o)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, kv_pad, m, l, do, delta,
                                         causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, kv_pad, m, l, do, delta, causal)
    ref = fa.flash_attention_bwd_ref(q, k, v, kv_pad, o, m, l, do, causal)
    outs = [got[0], dq, dk, dv]
    wants = [o, *ref]
    held = [0, 1, 2, 3]
    if k.shape[1] == 1:     # dq and dk: rounding noise (FLASH_ONE_KEY_REL)
        held = [0, 3]
        terms = float(do.float().abs().max() * v.float().abs().max())
        for g, other in ((dq, k), (dk, q)):
            if not (float(g.float().abs().max()) <= FLASH_ONE_KEY_REL * terms
                    * float(other.float().abs().max())):
                raise AssertionError(f"flash attention {what}: one key, "
                                     f"dq or dk above the rounding bound")
    ulps, norm = stack_errors([outs[i] for i in held],
                              [wants[i] for i in held])
    live = m > 0.5 * fa.NEG_INF
    ml = max(rel_max(got[1][live], m[live]), rel_max(got[2][live], l[live]))
    if not (ulps <= FLASH_MAX_ULPS and norm <= FLASH_REL_NORM
            and ml <= FLASH_ML_REL):
        raise AssertionError(f"flash attention {what}: max err {ulps:.3g} "
                             f"bf16 ulps, rel norm err {norm:.3g}, m/l rel "
                             f"err {ml:.3g}")
    dead = ~live.any(dim=(1, 2))            # batch rows with no live row
    if bool(dead.any()):
        for t in outs:
            if bool(t[dead].any()):
                raise AssertionError(f"flash attention {what}: a dead row "
                                     f"has nonzero output or gradient")
    abs_err = [float((g.float() - w.float()).abs().max())
               for g, w in zip(outs, wants)]
    errs = {"flash_attention_fwd": abs_err[0],
            "flash_attention_bwd_dq": abs_err[1],
            "flash_attention_bwd_dkdv": max(abs_err[2:])}
    return errs, ulps, norm, ml


def flash_phase(dev, log, seeds: int):
    """Phase 5: the flash kernels against their plain versions, each case
    from ``seeds`` seeds."""
    worst = {"err": dict.fromkeys(FLASH_KERNELS, 0.0), "ulps": 0.0,
             "norm": 0.0, "ml": 0.0}
    cases = [(f"{what} Tq {tq} Tk {tk}{' causal' if causal else ''}",
              (BATCH, 8, 128, tq, tk, causal), "tail")
             for what, tq, tk, causal, _ in FLASH_SHAPES]
    cases += list(FLASH_EXTRA_CASES)
    for seed in range(seeds):
        for what, (b, h, d, tq, tk, causal), pad in cases:
            q, k, v, kv_pad, do = flash_inputs(dev, b, h, d, tq, tk, causal,
                                               SEED + 10 * seed, pad)
            errs, ulps, norm, ml = check_flash_case(q, k, v, kv_pad, do,
                                                    causal, what)
            for key, val in zip(("ulps", "norm", "ml"), (ulps, norm, ml)):
                worst[key] = max(worst[key], val)
            for name, val in errs.items():
                worst["err"][name] = max(worst["err"][name], val)
            log(f"[5] flash {what}, seed {seed}: max err {ulps:.3g} bf16 "
                f"ulps, relative norm error {norm:.3g}, m/l relative error "
                f"{ml:.3g}; max abs err: o {errs['flash_attention_fwd']:.3g},"
                f" dk/dv {errs['flash_attention_bwd_dkdv']:.3g}, dq "
                f"{errs['flash_attention_bwd_dq']:.3g}")
    # the check must tell a wrong attention apart: the plain version
    # without its key-pad mask has to fail it
    q, k, v, kv_pad, do = flash_inputs(dev, BATCH, 8, 128, 20, 20, True, SEED)
    got = fa.flash_attention_fwd(q, k, v, kv_pad, True)[0]
    unmasked = fa.flash_attention_fwd_ref(q, k, v, None, True)[0]
    ulps, norm = stack_errors([got], [unmasked])
    if ulps <= FLASH_MAX_ULPS and norm <= FLASH_REL_NORM:
        raise AssertionError("the flash check passes a plain version "
                             "without its key-pad mask")
    log(f"[5] control: the plain version without its key-pad mask reads "
        f"{ulps:.3g} bf16 ulps, relative norm error {norm:.3g} (fails the "
        f"check, as it must)")
    return worst


def device_ms(fn, calls: int) -> float:
    """Device time per call of ``fn`` by profiler: for each of its device
    kernels, the mean time of a recorded launch times its launches per
    call.  The profiler may drop the records of some launches (a full run
    once recorded one of three multi-tile calls), so the launches per call
    are the records per call rounded up: every call of ``fn`` launches the
    same kernels.  It may also record none of them (a full run once read
    0 us for the 3 x 3 forward); a call that launches a kernel takes
    device time, so such a reading is taken again, up to twice more."""
    for _ in range(3):
        ms = sum(t / n * math.ceil(n - 1e-6)
                 for n, t in profile_groups(fn, calls).values() if n)
        if ms > 0.0:
            break
    return ms


def kernel_family(name: str, families) -> str:
    """The entry of ``families`` that the device kernel ``name`` is an
    instance of (a whole identifier in the profiler's demangled name), or
    "other"."""
    return next((f for f in families
                 if re.search(rf"(?<![A-Za-z0-9_]){f}(?![A-Za-z0-9_])", name)),
                "other")


def launches_per_call(fn, want: dict, what: str) -> float:
    """Raises unless each call of ``fn`` runs the device kernels ``want``
    ({kernel: launches per call}) and nothing else (by profiler, which may
    drop records but never adds one: a kernel recorded fewer times passes,
    more times fails); returns the device ms per call, each kernel's
    records rounded up to ``want``."""
    for _ in range(3):
        groups = profile_groups(fn, 4)
        if groups:
            break
    got, ms = {}, 0.0
    for name, (n, t) in groups.items():
        fam = kernel_family(name, want)
        got[fam] = got.get(fam, 0.0) + n
        if n:
            ms += t / n * want.get(fam, 1)
    bad = [f for f, n in got.items() if n > want.get(f, 0) + 1e-6]
    if bad or not got:
        raise AssertionError(f"{what}: device kernels per call "
                             f"{ {k: round(v, 3) for k, v in got.items()} }, "
                             f"want {want}")
    return ms


def flash_shape_times(dev, b, h, d, tq, tk, causal, pad, iters):
    """Per-call times at one shape, in ms: each flash kernel by events and
    by profiler (device time), the plain forward and backward by events,
    and SDPA forward and backward (its mask: True = attend; the backward
    from saved state) by events and by profiler.  Returns (times,
    flash_bounds)."""
    q, k, v, kv_pad, do = flash_inputs(dev, b, h, d, tq, tk, causal,
                                       SEED + 1, pad)
    o, m, l = fa.flash_attention_fwd_ref(q, k, v, kv_pad, causal)
    delta = fa.row_delta(do, o)
    fns = {"flash_attention_fwd":
               lambda: fa.flash_attention_fwd(q, k, v, kv_pad, causal),
           "flash_attention_bwd_dkdv":
               lambda: fa.flash_attention_bwd_dkdv(q, k, v, kv_pad, m, l, do,
                                                   delta, causal),
           "flash_attention_bwd_dq":
               lambda: fa.flash_attention_bwd_dq(q, k, v, kv_pad, m, l, do,
                                                 delta, causal)}
    allowed = ~kv_pad[:, None, None, :]
    if causal:
        allowed = allowed & ~torch.ones((tq, tk), dtype=torch.bool,
                                        device=dev).triu(1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns["sdpa_fwd"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allowed, scale=1.0)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=allowed, scale=1.0)
    dot = do.transpose(1, 2)
    fns["sdpa_bwd"] = lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                                  retain_graph=True)
    t = {}
    for name, fn in fns.items():
        t[name] = cuda_ms(fn, iters)
        t[name + ":device"] = device_ms(fn, max(3, iters // 3))
    t["plain_fwd"] = cuda_ms(
        lambda: fa.flash_attention_fwd_ref(q, k, v, kv_pad, causal),
        max(2, iters // 3))
    t["plain_bwd"] = cuda_ms(
        lambda: fa.flash_attention_bwd_ref(q, k, v, kv_pad, o, m, l, do,
                                           causal), max(2, iters // 3))
    return t, flash_bounds(q, k, kv_pad, causal)


def flash_shape_line(card, what, t) -> str:
    us = lambda key: f"{t[key] * 1e3:.1f} us"
    both = lambda key: f"{us(key)} (device {us(key + ':device')})"
    return (f"[7] {card}: flash {what}, per call, by events (device time "
            f"by profiler): fwd kernel {both('flash_attention_fwd')}, plain "
            f"{us('plain_fwd')}, SDPA {both('sdpa_fwd')}; dK/dV kernel "
            f"{both('flash_attention_bwd_dkdv')} + dQ kernel "
            f"{both('flash_attention_bwd_dq')}, plain backward "
            f"{us('plain_bwd')}, SDPA backward {both('sdpa_bwd')}")


def flash_timings(dev, card, log):
    """Phase 7 (kernels): per-call times at the four training shapes, the
    totals of one latent train step's calls, and one call at the
    multi-tile shape (``long_*``).  The two backward rows share their
    plain and library times: the plain backward and SDPA's backward each
    compute dq, dk and dv in one call."""
    totals = {n: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "library_ms": 0.0,
                  "library_device_ms": 0.0, "bytes": 0.0, "flops": 0.0}
              for n in FLASH_KERNELS}
    fwd = []    # the forward's and SDPA forward's device times per call
    for what, tq, tk, causal, calls in FLASH_SHAPES:
        t, bounds = flash_shape_times(dev, BATCH, 8, 128, tq, tk, causal,
                                      "tail", 50)
        fwd.append((f"{tq}x{tk}{' causal' if causal else ''}", t))
        for name, (nbytes, flops) in bounds.items():
            b_ms, _ = bound(nbytes, flops)
            side = "fwd" if name.endswith("fwd") else "bwd"
            tot = totals[name]
            tot["ms"] += calls * t[name]
            tot["device_ms"] += calls * t[name + ":device"]
            tot["plain_ms"] += calls * t["plain_" + side]
            tot["library_ms"] += calls * t["sdpa_" + side]
            tot["library_device_ms"] += calls * t[f"sdpa_{side}:device"]
            tot["bound_ms"] += calls * b_ms
            tot["bytes"] += calls * nbytes
            tot["flops"] += calls * flops
        log(flash_shape_line(card, f"{what} (B {BATCH}, H 8, Dh 128, Tq {tq},"
                             f" Tk {tk}{', causal' if causal else ''})", t))
    for name, tot in totals.items():
        tot["bound_by"] = bound(tot["bytes"], tot["flops"])[1]
        shared = ("" if name.endswith("fwd") else
                  " (shared by both backward rows: dq, dk and dv in one call)")
        log(f"[7] {card}: {name}, the 24 calls of a latent train step: "
            f"kernel {tot['ms'] * 1e3:.1f} us by events, "
            f"{tot['device_ms'] * 1e3:.1f} us device, bound "
            f"{tot['bound_ms'] * 1e3:.2f} us ({tot['bound_by']}); plain "
            f"{tot['plain_ms'] * 1e3:.1f} us and SDPA "
            f"{tot['library_ms'] * 1e3:.1f} us "
            f"({tot['library_device_ms'] * 1e3:.1f} us device){shared}")
    what, (b, h, d, tq, tk, causal), pad = FLASH_MULTI_TILE
    t, bounds = flash_shape_times(dev, b, h, d, tq, tk, causal, pad, 10)
    log(flash_shape_line(card, what, t))
    fwd.append(("multi-tile", t))
    log(f"[7] {card}: flash_attention_fwd per call, device time by "
        f"profiler against SDPA forward's: " + ", ".join(
            f"{shape} {x['flash_attention_fwd:device'] * 1e3:.1f} us (SDPA "
            f"{x['sdpa_fwd:device'] * 1e3:.1f} us)" for shape, x in fwd))
    for name, (nbytes, flops) in bounds.items():
        b_ms, b_by = bound(nbytes, flops)
        side = "fwd" if name.endswith("fwd") else "bwd"
        totals[name].update(
            long_ms=t[name], long_device_ms=t[name + ":device"],
            long_plain_ms=t["plain_" + side], long_bound_ms=b_ms,
            long_bound_by=b_by, long_library_ms=t["sdpa_" + side],
            long_library_device_ms=t[f"sdpa_{side}:device"])
        log(f"[7] {card}: {name}, one call at the multi-tile shape: bound "
            f"{b_ms * 1e3:.2f} us ({b_by})")
    return totals


# ---------------------------------------------------------------------------
# training

def flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().float().flatten()
                      for p in model.parameters()])


def train_compare(dev, seed: int, log):
    """Phase 6: flagship training on the kernel path and the einsum path
    from the same weights (made from ``seed``), batch and generator seeds.
    Returns (the flash launch counts of the kernel path, the worst
    differences, the run's (cfg, kernel state, einsum cfg, einsum state,
    batch))."""
    cfg = serve.flagship_config().replace(use_pallas_attention=True,
                                          attention_dropout=0.0)
    t0 = time.perf_counter()
    kmodel = IQ(cfg, serve.FLAGSHIP_VOCAB).to(dev)
    kstate = create_train_state(cfg, kmodel, seed=seed)
    ecfg = cfg.replace(use_pallas_attention=False)
    emodel = IQ(ecfg, serve.FLAGSHIP_VOCAB).to(dev)
    emodel.load_state_dict(kmodel.state_dict())
    estate = create_train_state(ecfg, emodel, seed=None)
    batch = make_batch(cfg, serve.FLAGSHIP_VOCAB, BATCH,
                       np.random.RandomState(seed + 200), dev)
    nparams = sum(p.numel() for p in kstate.trainable().values())
    torch.cuda.synchronize()
    log(f"[6] seed {seed}: two flagship train states ready in "
        f"{time.perf_counter() - t0:.1f} s: {nparams / 1e6:.1f} M trainable "
        f"parameters, {cfg.dtype} compute, f32 parameters, use_pallas_"
        f"attention on / off, attention_dropout {cfg.attention_dropout}, "
        f"relu_dropout {cfg.relu_dropout}; TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}; target lengths "
        f"{(batch['target'] != 0).sum(1).min().item()}-"
        f"{(batch['target'] != 0).sum(1).max().item()}")
    theta0 = flat_params(emodel)
    gens = [torch.Generator(dev).manual_seed(seed + 300) for _ in range(2)]
    worst = {"loss": 0.0, "gnorm": 0.0, "param": 0.0}
    for fn in FLASH_KERNELS:
        getattr(fa, fn).launches = 0
    for i, latent_mode in enumerate((False,) * 3 + (True,) * 3):
        if i == 3:
            kstate.reset_optimizer()
            estate.reset_optimizer()
        _, mk = make_train_step(cfg, latent_mode)(kstate, batch, gens[0])
        _, me = make_train_step(ecfg, latent_mode)(estate, batch, gens[1])
        mk = {n: float(v) for n, v in mk.items()}
        me = {n: float(v) for n, v in me.items()}
        if not all(math.isfinite(v) for v in (*mk.values(), *me.values())):
            raise AssertionError(f"train step {i}: non-finite metrics {mk}")
        if latent_mode != (mk["kld"] > 0.0):
            raise AssertionError(f"train step {i}: kld {mk['kld']}")
        if not latent_mode and (mk["kld"] != 0.0 or mk["aux"] != 0.0):
            raise AssertionError(f"pretrain step {i}: kld/aux not zero")
        loss_rel = abs(mk["loss"] - me["loss"]) / abs(me["loss"])
        gnorm_rel = abs(mk["grad_norm"] - me["grad_norm"]) / me["grad_norm"]
        theta_k, theta_e = flat_params(kmodel), flat_params(emodel)
        param_rel = float((theta_k - theta_e).norm()
                          / (theta_e - theta0).norm().clamp_min(1e-30))
        del theta_k, theta_e
        for key, val in zip(worst, (loss_rel, gnorm_rel, param_rel)):
            worst[key] = max(worst[key], val)
        log(f"[6] seed {seed}, {'latent' if latent_mode else 'pretrain'} "
            f"step {i}: loss {mk['loss']:.6g} (einsum {me['loss']:.6g}), rec "
            f"{mk['rec']:.5g}, kld {mk['kld']:.5g}, aux {mk['aux']:.5g}, "
            f"grad_norm {mk['grad_norm']:.6g} (einsum {me['grad_norm']:.6g});"
            f" relative: loss {loss_rel:.3g}, grad_norm {gnorm_rel:.3g}, "
            f"parameters {param_rel:.3g} of their motion")
    ev_k = make_eval_step(cfg, True)(kstate, batch, gens[0])
    ev_e = make_eval_step(ecfg, True)(estate, batch, gens[1])
    launches = {fn: getattr(fa, fn).launches for fn in FLASH_KERNELS}
    log(f"[6] seed {seed}, eval step: loss {float(ev_k['loss']):.6g} "
        f"(einsum {float(ev_e['loss']):.6g}), aux_acc "
        f"{float(ev_k['aux_acc']):.4g}; flash launches {launches}")
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"flash launch counts {launches}, want "
                             f"{TRAIN_LAUNCHES}")
    ev_rel = abs(float(ev_k["loss"]) - float(ev_e["loss"])) / abs(
        float(ev_e["loss"]))
    worst["loss"] = max(worst["loss"], ev_rel)
    log(f"[6] seed {seed}: kernel path against einsum path, worst over the "
        f"steps: loss {worst['loss']:.3g}, grad_norm {worst['gnorm']:.3g}, "
        f"parameters {worst['param']:.3g} (limits {TRAIN_LOSS_REL}, "
        f"{TRAIN_GNORM_REL}, {TRAIN_PARAM_REL})")
    if not (worst["loss"] <= TRAIN_LOSS_REL and worst["gnorm"] <= TRAIN_GNORM_REL
            and worst["param"] <= TRAIN_PARAM_REL):
        raise AssertionError(f"kernel path against einsum path: {worst}")
    return launches, worst, (cfg, kstate, ecfg, estate, batch)


def profile_groups(fn, calls: int, keys=None) -> dict:
    """{group: (launches, device ms)} per call of ``fn``, by profiler over
    ``calls`` calls after one warm-up call: the device kernels whose names
    contain each of ``keys``, and the rest as "other" (without ``keys``,
    each kernel name is a group)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    groups = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(evt, "self_device_time_total", 0.0)
              or getattr(evt, "self_cuda_time_total", 0.0))
        key = (evt.key if keys is None else
               next((k for k in keys if k in evt.key), "other"))
        n, t = groups.get(key, (0, 0.0))
        groups[key] = (n + evt.count / calls, t + us / 1e3 / calls)
    return groups


def train_times(dev, card, log, cfg, kstate, ecfg, estate, batch):
    """Phase 7 (training): latent train-step times on both paths, in turns,
    and the device time of one step on each by profiler."""
    def steps(state, c):
        step = make_train_step(c, True)
        g = torch.Generator(dev).manual_seed(1)
        return lambda: step(state, batch, g)

    t_k = [cuda_ms(steps(kstate, cfg), 3, warmup=1)]
    t_e = [cuda_ms(steps(estate, ecfg), 3, warmup=1)]
    t_e.append(cuda_ms(steps(estate, ecfg), 3, warmup=0))
    t_k.append(cuda_ms(steps(kstate, cfg), 3, warmup=0))
    k_ms, e_ms = min(t_k), min(t_e)
    log(f"[7] {card}: latent train step b{BATCH}: flash path {k_ms:.2f} ms "
        f"= {BATCH / k_ms * 1e3:.1f} samples/s (runs {t_k}); einsum path "
        f"{e_ms:.2f} ms = {BATCH / e_ms * 1e3:.1f} samples/s (runs {t_e})")

    for what, state, c, wall_ms in (("flash", kstate, cfg, k_ms),
                                    ("einsum", estate, ecfg, e_ms)):
        groups = profile_groups(steps(state, c), 1, FLASH_STEP_KERNELS)
        dev_ms = sum(t for _, t in groups.values())
        launches = int(sum(n for n, _ in groups.values()))
        flash = {k: groups[k] for k in FLASH_STEP_KERNELS if k in groups}
        flash_ms = sum(t for _, t in flash.values())
        log(f"[7] {card}: profiled latent train step, {what} path: device "
            f"kernel time {dev_ms:.2f} ms in {launches} kernels, of which "
            f"flash kernels {flash_ms:.3f} ms (" + ", ".join(
                f"{k}* {t:.3f} ms in {n:.0f}" for k, (n, t) in flash.items())
            + f"); busy share {dev_ms / wall_ms:.3f} of the {wall_ms:.2f} ms "
            f"step")
        # the bf16 step's 24 attention calls run the three tensor-core
        # kernels once each, and none reaches an FMA kernel
        if what == "flash" and (
                any(flash.get(k, (0, 0.0))[0] != 24 for k in FLASH_MMA)
                or any(k in flash for k in FLASH_FMA)):
            raise AssertionError(f"flash kernels of the bf16 latent step: "
                                 f"{flash}")


# ---------------------------------------------------------------------------
# the per-layer decode path and int8_matmul

def per_layer_model(model, cfg, dev):
    """The flagship on the per-layer path (streaming off), with ``model``'s
    weights cast to the compute dtype."""
    pl_cfg = cfg.replace(use_stream_decode=False, use_pallas_decode=True)
    pl_model = IQ(pl_cfg, model.vocab_size)
    pl_model.load_state_dict(model.state_dict())
    cast_to_compute_dtype_(pl_model)
    return pl_cfg, pl_model.to(dev).eval()


def layer_case(cfg, b: int, seed: int, dev) -> dict:
    """bf16 inputs of the per-layer kernels at batch b (scale 2): x, one
    layer's caches [H, Lmax, B, Dh], cross K/V [B, Tc, H, Dh], a source mask
    that pads the last context column and masks batch row 1 fully, and
    pad-key marks [B, Lmax] (row 0, the <pad> seed, always marked)."""
    h, dh = cfg.num_heads, cfg.head_dim
    lmax, tc = cfg.max_decode_length + 1, cfg.max_context_len
    g = torch.Generator(dev).manual_seed(seed)

    def n(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 2.0).to(
            torch.bfloat16)

    src_pad = torch.zeros((b, tc), dtype=torch.bool, device=dev)
    src_pad[:, tc - 1] = True
    src_pad[1] = True
    marks = torch.rand((b, lmax), generator=g, device=dev) < 0.3
    marks[:, 0] = True
    return {"x": n(b, cfg.hidden_dim), "ck": n(h, lmax, b, dh),
            "cv": n(h, lmax, b, dh), "xk": n(b, tc, h, dh),
            "xv": n(b, tc, h, dh), "src_pad": src_pad, "marks": marks}


def key_pad_at(marks, pos: int):
    """The [Lmax, B] f32 key-pad view of ``marks`` at ``pos``: nothing
    marked past pos (the kernels' precondition)."""
    m = marks.clone()
    m[:, pos + 1:] = False
    return m.float().T


def self_args(w, x, ck, cv, pos: int, nh: int):
    return (x, *w["ln_self"], w["wqkv"], w["wout"], ck, cv, pos, nh)


def cross_args(w, x, xk, xv, src_pad):
    return (x, *w["ln_cross"], w["wq"], xk, xv, src_pad, w["wo"],
            *w["ln_ffn"], w["w1"], w["b1"], w["w2"], w["b2"])


def self_pair(w, x, ck, cv, pos: int, nh: int, key_pad=None):
    """The kernel's and the plain version's (out, written k row, written v
    row) of one self_attn_step, each on its own copy of the caches."""
    res = []
    for fn in (decode_layer.self_attn_step, decode_layer.self_attn_step_ref):
        k, v = ck.clone(), cv.clone()
        out, k, v = fn(*self_args(w, x, k, v, pos, nh), key_pad=key_pad)
        res.append((out, k[:, pos], v[:, pos]))
    return res


def new_worst(names):
    return {n: {"err": 0.0, "ulps": 0.0, "norm": 0.0} for n in names}


def note(worst: dict, name: str, reading) -> None:
    for key, val in zip(("err", "ulps", "norm"), reading):
        worst[name][key] = max(worst[name][key], val)


def layer_phase(dev, log, pl_model, seeds: int):
    """Phase 8: the per-layer kernels against their plain versions with the
    model's own weights (every layer), at each batch, position and key-pad
    case, from ``seeds`` input seeds; then the no-source-mask control."""
    cfg = pl_model.cfg
    nh = cfg.num_heads
    lws = pl_model.decoder.layer_weights()
    worst = new_worst(LAYER_KERNELS)
    for seed in range(seeds):
        for b in LAYER_BATCHES:
            c = layer_case(cfg, b, SEED + 7 + 100 * seed + b, dev)
            for pos in LAYER_POSITIONS:
                for marked in (False, True):
                    kp = key_pad_at(c["marks"], pos) if marked else None
                    what = (f"self_attn_step b{b} pos {pos}"
                            f"{' key_pad' if marked else ''}")
                    case = new_worst([what])
                    for l, w in enumerate(lws):
                        got, want = self_pair(w, c["x"], c["ck"], c["cv"],
                                              pos, nh, kp)
                        reading = check_close(got, want, f"{what} layer {l}",
                                              LAYER_MAX_ULPS, LAYER_REL_NORM)
                        note(case, what, reading)
                        note(worst, "self_attn_step", reading)
                    r = case[what]
                    log(f"[8] seed {seed}, {what}, worst of {len(lws)} "
                        f"layers over out, k and v: max err {r['ulps']:.3g} "
                        f"bf16 ulps, relative norm error {r['norm']:.3g}, "
                        f"max abs err {r['err']:.4g}")
            what = f"cross_ffn_step b{b}"
            case = new_worst([what])
            for l, w in enumerate(lws):
                args = cross_args(w, c["x"], c["xk"], c["xv"], c["src_pad"])
                reading = check_close([decode_layer.cross_ffn_step(*args, nh)],
                                      [decode_layer.cross_ffn_step_ref(*args,
                                                                       nh)],
                                      f"{what} layer {l}", LAYER_MAX_ULPS,
                                      LAYER_REL_NORM)
                note(case, what, reading)
                note(worst, "cross_ffn_step", reading)
            r = case[what]
            log(f"[8] seed {seed}, {what}, worst of {len(lws)} layers: max "
                f"err {r['ulps']:.3g} bf16 ulps, relative norm error "
                f"{r['norm']:.3g}, max abs err {r['err']:.4g}")
            if seed == 0:
                launches_per_call(
                    lambda: decode_layer.cross_ffn_step(*args, nh),
                    CROSS_KERNELS, what)
                log(f"[8] {what}: {sum(CROSS_KERNELS.values())} kernels "
                    f"per call {CROSS_KERNELS} (profiler)")
                k, v = c["ck"].clone(), c["cv"].clone()
                kp = key_pad_at(c["marks"], 25)
                launches_per_call(
                    lambda: decode_layer.self_attn_step(
                        *self_args(lws[0], c["x"], k, v, 25, nh), key_pad=kp),
                    SELF_KERNELS, f"self_attn_step b{b}")
                log(f"[8] self_attn_step b{b}: "
                    f"{sum(SELF_KERNELS.values())} kernels per call "
                    f"{SELF_KERNELS} (profiler)")
    # the check must tell a wrong cross step apart: the plain version
    # without its source mask has to fail it
    c = layer_case(cfg, LAYER_BATCHES[0], SEED + 7, dev)
    got = decode_layer.cross_ffn_step(
        *cross_args(lws[0], c["x"], c["xk"], c["xv"], c["src_pad"]), nh)
    unmasked = decode_layer.cross_ffn_step_ref(
        *cross_args(lws[0], c["x"], c["xk"], c["xv"],
                    torch.zeros_like(c["src_pad"])), nh)
    ulps, norm = stack_errors([got], [unmasked])
    if ulps <= LAYER_MAX_ULPS and norm <= LAYER_REL_NORM:
        raise AssertionError("the cross_ffn_step check passes a plain "
                             "version without its source mask")
    log(f"[8] control: the plain cross_ffn_step without its source mask reads"
        f" {ulps:.3g} bf16 ulps, relative norm error {norm:.3g} (fails the "
        f"check, as it must)")
    return worst


def layer_launches():
    return {k: getattr(decode_layer, k).launches for k in LAYER_KERNELS}


def zero_layer_launches():
    for k in LAYER_KERNELS:
        getattr(decode_layer, k).launches = 0


def check_tokens(tokens, b: int, steps: int, vocab: int, what: str):
    if tuple(tokens.shape) != (b, steps):
        raise AssertionError(f"{what}: tokens shape {tuple(tokens.shape)}")
    if not (int(tokens.min()) >= 0 and int(tokens.max()) < vocab):
        raise AssertionError(f"{what}: token ids outside the vocab")


def layer_path_phase(dev, log, pl_cfg, pl_model, latent, images, context,
                     z_seed: int):
    """Phase 9: the per-layer path through its entry points: a greedy b64
    decode and a beam decode at b64 x BEAM, their launch counts, a
    teacher-forced replay of the greedy decode (every kernel call against
    its plain version), and a top_k=1 sampled decode.  Returns (the greedy
    decode's launches, the replay's readings)."""
    b = images.shape[0]
    steps, nl = pl_cfg.max_decode_length + 1, pl_cfg.num_layers
    nh, vocab = pl_cfg.num_heads, pl_model.vocab_size
    want = {k: steps * nl for k in LAYER_KERNELS}

    zero_layer_launches()
    t0 = time.perf_counter()
    tokens = make_decode_step(pl_cfg, pl_model, latent, with_probe=False)(
        images, context, torch.Generator(dev).manual_seed(z_seed))["tokens"]
    torch.cuda.synchronize()
    launches = layer_launches()
    check_tokens(tokens, b, steps, vocab, "per-layer greedy")
    if launches != want:
        raise AssertionError(f"per-layer greedy launches {launches}, want "
                             f"{want}")
    log(f"[9] per-layer greedy decode b{b}: tokens [{b}, {steps}] in [0, "
        f"{vocab}), launches {launches}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock, first "
        f"call); first rows {tokens[:2, :8].tolist()}")
    # the same decode under the profiler: one cross-attention kernel per
    # cross_ffn_step call, one self-attention kernel per self_attn_step call
    calls = decode_layer.cross_ffn_step.launches
    groups = profile_groups(lambda: make_decode_step(
        pl_cfg, pl_model, latent, with_probe=False)(
        images, context, torch.Generator(dev).manual_seed(z_seed)), 1,
        ("layer_cross_attn_kernel", "self_attn_warp_kernel"))
    calls = (decode_layer.cross_ffn_step.launches - calls) / 2
    ran = [groups.get(k, (0.0, 0.0))[0]
           for k in ("layer_cross_attn_kernel", "self_attn_warp_kernel")]
    if calls != steps * nl or not all(0 < r <= calls for r in ran):
        raise AssertionError(f"per-layer decode: {calls} cross_ffn_step and "
                             f"self_attn_step calls ran {ran} cross- and "
                             f"self-attention kernels; kernels {groups}")
    log(f"[9] a profiled greedy decode: {calls:.0f} cross_ffn_step and "
        f"self_attn_step calls, {ran[0]:.0f} layer_cross_attn_kernel and "
        f"{ran[1]:.0f} self_attn_warp_kernel launches")

    # teacher-forced replay: the same steps, each kernel call held against
    # its plain version on the same inputs
    plan = pl_model.prepare_decode(images, context, pl_cfg.max_decode_length,
                                   latent, False, pl_cfg.decode_z_source,
                                   torch.Generator(dev).manual_seed(z_seed))
    caches = pl_model.decoder.init_cache(b, steps, dev)
    tc = plan["cross_kvs"][0][0].shape[1]
    src_pad = plan["src_mask"][:, 0, 0, :].expand(b, tc)
    token = torch.full((b,), PAD if pl_cfg.compat_pad_seed else START,
                       dtype=torch.int32, device=dev)
    replay = new_worst(LAYER_KERNELS)
    same = 0
    for pos in range(steps):
        x_t = pl_model.embed_tokens(token[:, None])
        if pos == 0:
            x_t = x_t + plan["inject"][:, None]
        x = (x_t + pl_model.decoder.timing[pos].to(x_t.dtype))[:, 0]
        for l, (w, (ck, cv), (xk, xv)) in enumerate(zip(
                plan["layers"], caches, plan["cross_kvs"])):
            got, ref = self_pair(w, x, ck, cv, pos, nh)
            note(replay, "self_attn_step", check_close(
                got, ref, f"replay pos {pos} layer {l} self_attn_step",
                LAYER_MAX_ULPS, LAYER_REL_NORM))
            x, ck[:, pos], cv[:, pos] = got
            args = cross_args(w, x, xk, xv, src_pad)
            x = decode_layer.cross_ffn_step(*args, nh)
            note(replay, "cross_ffn_step", check_close(
                [x], [decode_layer.cross_ffn_step_ref(*args, nh)],
                f"replay pos {pos} layer {l} cross_ffn_step",
                LAYER_MAX_ULPS, LAYER_REL_NORM))
        logits = pl_model.output_proj(
            pl_model.decoder.final_ln(x[:, None])[:, 0].float())
        check_head(tokens[:, pos], logits, f"per-layer replay pos {pos}")
        same += int((logits.argmax(dim=-1) == tokens[:, pos]).sum())
        token = tokens[:, pos]
    log(f"[9] replay of the greedy decode: {steps} steps x {nl} layers "
        f"within tolerance (self_attn_step: max err "
        f"{replay['self_attn_step']['ulps']:.3g} bf16 ulps, relative norm "
        f"error {replay['self_attn_step']['norm']:.3g}; cross_ffn_step: "
        f"{replay['cross_ffn_step']['ulps']:.3g} ulps, "
        f"{replay['cross_ffn_step']['norm']:.3g}); {same}/{b * steps} "
        f"replayed tokens equal to the decoded ones")

    zero_layer_launches()
    t0 = time.perf_counter()
    beam = make_beam_decode_step(pl_cfg.replace(beam_size=BEAM), pl_model,
                                 latent)(
        images, context, torch.Generator(dev).manual_seed(z_seed))
    torch.cuda.synchronize()
    beam_launches = layer_launches()
    check_tokens(beam["tokens"], b, steps, vocab, "per-layer beam")
    if not bool(torch.isfinite(beam["scores"]).all()):
        raise AssertionError("per-layer beam: scores not finite")
    if beam_launches != want:
        raise AssertionError(f"per-layer beam launches {beam_launches}, want"
                             f" {want}")
    log(f"[9] per-layer beam decode b{b} x {BEAM} beams: tokens [{b}, "
        f"{steps}] in [0, {vocab}), scores finite in "
        f"[{float(beam['scores'].min()):.4g}, "
        f"{float(beam['scores'].max()):.4g}], launches {beam_launches}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock, first "
        f"call)")

    sampled = make_decode_step(
        pl_cfg.replace(decode_sampling=True, decode_top_k=1), pl_model,
        latent, with_probe=False)(
        images, context, torch.Generator(dev).manual_seed(z_seed),
        torch.Generator(dev).manual_seed(z_seed + 1))["tokens"]
    if not torch.equal(sampled, tokens):
        raise AssertionError("the top_k=1 sampled decode differs from the "
                             "greedy decode")
    log(f"[9] sampled decode with top_k=1: all {b * steps} tokens equal to "
        f"the greedy decode's")
    return launches, replay


def int8_phase(dev, log, model, seeds: int):
    """Phase 10: int8_matmul launched at the two flagship shapes with the
    model's own weights quantized (vocab head; layer 0's FFN in), held
    against its plain version (and from ``seeds`` - 1 more input seeds);
    then the wrong-scales control.  Returns (cases, launches of the first
    drive, worst readings)."""
    weights = (model.output_proj.weight, model.decoder.layers[0].ffn.ffn_in.weight)
    quantized = []
    for (what, m, k, n), w in zip(INT8_SHAPES, weights):
        w8, scale = i8mm.quantize_int8(w.float().T)
        if tuple(w8.shape) != (k, n):
            raise AssertionError(f"int8_matmul {what}: weights {tuple(w8.shape)}")
        quantized.append((what, m, w8.contiguous(), scale.contiguous()))
    worst = new_worst(["int8_matmul"])
    for seed in range(seeds):
        g = torch.Generator(dev).manual_seed(SEED + 5 + seed)
        cases = [(what, (torch.randn((m, w8.shape[0]), generator=g,
                                     device=dev) * 2.0).to(torch.bfloat16),
                  w8, s) for what, m, w8, s in quantized]
        i8mm.int8_matmul.launches = 0
        ys = [i8mm.int8_matmul(x, w8, s) for _, x, w8, s in cases]
        torch.cuda.synchronize()
        if seed == 0:
            launches, first = i8mm.int8_matmul.launches, (cases, ys)
            if launches != len(cases):
                raise AssertionError(f"int8_matmul launches {launches}")
        for (what, x, w8, s), y in zip(cases, ys):
            reading = check_close([y], [i8mm.int8_matmul_ref(x, w8, s)],
                                  f"int8_matmul {what}", INT8_MAX_ULPS,
                                  INT8_REL_NORM)
            note(worst, "int8_matmul", reading)
            log(f"[10] seed {seed}, int8_matmul {what} (M {x.shape[0]}, K "
                f"{x.shape[1]}, N {w8.shape[1]}): max err {reading[1]:.3g} "
                f"bf16 ulps, relative norm error {reading[2]:.3g}, max abs "
                f"err {reading[0]:.4g}")
    cases, ys = first
    # one kernel a call at both shapes: the TMA + wgmma kernel, by profiler
    for what, x, w8, s in cases:
        bn = i8mm.tma_columns(x.dtype, x.shape[0], x.shape[1], w8.shape[1])
        got = {}
        for name, (n, _) in profile_groups(
                lambda: i8mm.int8_matmul(x, w8, s), 4).items():
            fam = kernel_family(name, (INT8_KERNEL, "gemm_partial_kernel",
                                       "gemm_epilogue_kernel"))
            got[fam] = got.get(fam, 0.0) + n
        if not bn or set(got) != {INT8_KERNEL} or got[INT8_KERNEL] > 1 + 1e-6:
            raise AssertionError(f"int8_matmul {what}: {bn}-column tiles, "
                                 f"device kernels per call {got}")
        log(f"[10] int8_matmul {what}: one {INT8_KERNEL} launch a call "
            f"({bn}-column tiles) and nothing else (profiler)")
    # the check must tell wrong scales apart
    what, x, w8, s = cases[0]
    wrong = i8mm.int8_matmul_ref(x, w8, s.roll(1))
    ulps, norm = stack_errors([ys[0]], [wrong])
    if ulps <= INT8_MAX_ULPS and norm <= INT8_REL_NORM:
        raise AssertionError("the int8_matmul check passes wrong scales")
    log(f"[10] control: the plain version with its scales shifted by one "
        f"column reads {ulps:.3g} bf16 ulps, relative norm error {norm:.3g} "
        f"(fails the check, as it must)")
    return cases, launches, worst["int8_matmul"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def self_bound(w, c, pos: int):
    """Bytes and operations of one self_attn_step at ``pos``: x, the
    LayerNorm, the weights, cache rows 0..pos-1 read and row pos written,
    out written."""
    x, ck = c["x"], c["ck"]
    rows = nbytes(ck) * (pos + 1) / ck.shape[1] * 2
    moved = nbytes(x, *w["ln_self"], w["wqkv"], w["wout"]) + rows + nbytes(x)
    b, d = x.shape
    h, dh = w["wqkv"].shape[0], w["wout"].shape[1]
    return moved, 2 * b * (w["wqkv"].numel() + w["wout"].numel()) + \
        4 * b * h * dh * (pos + 1)


def cross_bound(w, c):
    """Bytes and operations of one cross_ffn_step."""
    x = c["x"]
    moved = nbytes(x, *w["ln_cross"], *w["ln_ffn"], w["wq"], w["wo"], w["w1"],
                   w["b1"], w["w2"], w["b2"], c["xk"], c["xv"], c["src_pad"],
                   x)
    b, tc = c["src_pad"].shape
    weights = sum(w[k].numel() for k in ("wq", "wo", "w1", "w2"))
    return moved, 2 * b * weights + 4 * b * x.shape[1] * tc


def int8_bound(x, w8, s):
    return (nbytes(x, w8, s) + x.shape[0] * w8.shape[1] * x.element_size(),
            2 * x.shape[0] * w8.shape[0] * w8.shape[1])


def cycled(fns):
    """One call of the next function of ``fns`` per call."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def layer_timings(dev, card, log, pl_cfg, pl_model, plain_model, latent,
                  images, context, int8_cases):
    """Phase 11: decode and beam q/s on the per-layer path against the
    plain path (in turns), each per-layer kernel at b64 and b256 (pos 25)
    and int8_matmul at both shapes against its plain version and
    ``torch._weight_int8pack_mm``.  Kernel times cycle over enough weight
    copies (the six layers; int8 copies) that they do not sit in L2."""
    b = images.shape[0]
    mdl, zs = pl_cfg.max_decode_length, pl_cfg.decode_z_source
    steps = mdl + 1

    def decode(m):
        return lambda: m.decode_greedy(
            images, context, mdl, latent, with_probe=False, z_source=zs,
            generator=torch.Generator(dev).manual_seed(1))

    def beam(m):
        return lambda: m.decode_beam(
            images, context, BEAM, mdl, latent,
            generator=torch.Generator(dev).manual_seed(1))

    path_ms = {}
    for what, fn, iters in (("decode", decode, 3), ("beam", beam, 2)):
        t_k = [cuda_ms(fn(pl_model), iters, warmup=1)]
        t_p = [cuda_ms(fn(plain_model), iters, warmup=1)]
        t_p.append(cuda_ms(fn(plain_model), iters, warmup=0))
        t_k.append(cuda_ms(fn(pl_model), iters, warmup=0))
        k_ms, p_ms = min(t_k), min(t_p)
        path_ms[what] = k_ms
        rows = f"b{b} x {BEAM} beams" if what == "beam" else f"b{b}"
        log(f"[11] {card}: {what} {rows} ({steps} steps) per-layer path "
            f"{k_ms:.2f} ms = {b / k_ms * 1e3:.1f} q/s (runs {t_k}); plain "
            f"path {p_ms:.2f} ms = {b / p_ms * 1e3:.1f} q/s (runs {t_p})")

    # where a per-layer decode's time goes: device time by kernel group,
    # against the decode's event time above (the profiler slows the host)
    groups = profile_groups(decode(pl_model), 1, LAYER_KERNEL_NAMES)
    total = sum(t for _, t in groups.values())
    parts = ", ".join(f"{k} {t:.2f} ms in {n}" for k, (n, t) in
                      sorted(groups.items(), key=lambda kv: -kv[1][1]))
    log(f"[11] {card}: profiled per-layer decode b{b}: device kernel time "
        f"{total:.2f} ms against {path_ms['decode']:.2f} ms by events (busy "
        f"share {total / path_ms['decode']:.3f}); {parts}")

    nh, pos = pl_cfg.num_heads, LAYER_TIME_POS
    lws = pl_model.decoder.layer_weights()
    timings = {}
    for bt in LAYER_BATCHES:
        cs = [layer_case(pl_cfg, bt, SEED + 3 + l, dev) for l in range(len(lws))]
        for name, run, ref, bound_fn in (
                ("self_attn_step",
                 lambda w, c: decode_layer.self_attn_step(
                     *self_args(w, c["x"], c["ck"], c["cv"], pos, nh)),
                 lambda w, c: decode_layer.self_attn_step_ref(
                     *self_args(w, c["x"], c["ck"], c["cv"], pos, nh)),
                 lambda w, c: self_bound(w, c, pos)),
                ("cross_ffn_step",
                 lambda w, c: decode_layer.cross_ffn_step(
                     *cross_args(w, c["x"], c["xk"], c["xv"], c["src_pad"]),
                     nh),
                 lambda w, c: decode_layer.cross_ffn_step_ref(
                     *cross_args(w, c["x"], c["xk"], c["xv"], c["src_pad"]),
                     nh),
                 cross_bound)):
            pairs = list(zip(lws, cs))
            k = cuda_ms(cycled([lambda w=w, c=c: run(w, c) for w, c in pairs]),
                        60)
            p = cuda_ms(cycled([lambda w=w, c=c: ref(w, c) for w, c in pairs]),
                        12)
            device = sum(t for _, t in profile_groups(
                cycled([lambda w=w, c=c: run(w, c) for w, c in pairs]),
                len(pairs), ()).values())
            moved, flops = bound_fn(*pairs[0])
            b_ms, b_by = bound(moved, flops)
            timings[(name, bt)] = (k, p, b_ms, b_by, device)
            log(f"[11] {card}: {name} b{bt} pos {pos}: kernel "
                f"{k * 1e3:.1f} us by events ({device * 1e3:.1f} us of "
                f"device time by profiler), plain {p * 1e3:.1f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}: {moved / 1e6:.2f} MB, "
                f"{flops / 1e9:.3f} GFLOP)")
        del cs

    for what, x, w8, s in int8_cases:
        copies = max(1, math.ceil(60e6 / nbytes(w8)))
        w8s = [w8.clone() for _ in range(copies)]
        k = cuda_ms(cycled([lambda w=w: i8mm.int8_matmul(x, w, s)
                            for w in w8s]), 60)
        p = cuda_ms(cycled([lambda w=w: i8mm.int8_matmul_ref(x, w, s)
                            for w in w8s]), 20)
        lib, why = None, ""
        if x.is_cuda and hasattr(torch, "_weight_int8pack_mm"):
            # the yardstick takes [N, K] weights and scales in x's dtype
            nk = [w.T.contiguous() for w in w8s]
            sb = s.to(x.dtype)
            try:
                torch._weight_int8pack_mm(x, nk[0], sb)
            except (RuntimeError, NotImplementedError) as e:
                why = f" (torch._weight_int8pack_mm does not run here: {e})"
            else:
                lib = cuda_ms(cycled([lambda w=w: torch._weight_int8pack_mm(
                    x, w, sb) for w in nk]), 60)
            del nk
        groups = profile_groups(
            cycled([lambda w=w: i8mm.int8_matmul(x, w, s) for w in w8s]),
            copies)
        device = sum(t for _, t in groups.values())
        moved, flops = int8_bound(x, w8, s)
        b_ms, b_by = bound(moved, flops)
        timings[("int8_matmul", what)] = (k, p, b_ms, b_by, lib, device)
        lib_text = (f"torch._weight_int8pack_mm {lib * 1e3:.1f} us"
                    if lib is not None else f"library: none{why}")
        log(f"[11] {card}: int8_matmul {what} (M {x.shape[0]}, K "
            f"{x.shape[1]}, N {w8.shape[1]}; {copies} weight copies "
            f"cycled): kernel {k * 1e3:.1f} us by events "
            f"({device * 1e3:.1f} us of device time by profiler), plain "
            f"{p * 1e3:.1f} us, "
            f"{lib_text}, bound {b_ms * 1e3:.2f} us ({b_by}: "
            f"{moved / 1e6:.2f} MB); per kernel (launches, us): "
            f"{kernel_split(groups)}")
        del w8s
    return timings


# ---------------------------------------------------------------------------
# ring attention

def ring_inputs(dev, b, n, c, pad, seed, d=128):
    """bf16 q (scaled), k, v, dO [B, T, H 8, Dh d] and a key-pad mask
    [B, T]: trailing pads of random lengths ("tail"), none ("none"), the
    last 10% of keys ("long"), or "dead": key 0 padded (the causal query 0
    sees no key) and every key of batch row 1."""
    t, h = n * c, 8
    g = torch.Generator(dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    q = (r(b, t, h, d) * d ** -0.5).to(torch.bfloat16)
    k, v, do = (r(b, t, h, d).to(torch.bfloat16) for _ in range(3))
    kv_pad = torch.zeros((b, t), dtype=torch.bool, device=dev)
    if pad == "tail":
        lengths = torch.randint(1, t + 1, (b,), generator=g, device=dev)
        kv_pad = torch.arange(t, device=dev)[None, :] >= lengths[:, None]
    elif pad == "long":
        kv_pad[:, t - t // 10:] = True
    elif pad == "dead":
        kv_pad[:, 0] = True
        kv_pad[1] = True
    return q, k, v, kv_pad.contiguous(), do


def ring_shards(x, n: int):
    """[B, T, ...] -> the ranks' shards [n, B, T / n, ...] (a view)."""
    return x.view(x.shape[0], n, x.shape[1] // n, *x.shape[2:]).transpose(0, 1)


def ring_pair(bidir: bool):
    return (("ring_attention_fwd_bidir_shard", "ring_attention_bwd_bidir_shard")
            if bidir else ("ring_attention_fwd_shard", "ring_attention_bwd_shard"))


def check_ring_case(q, k, v, kv_pad, do, n, causal, what: str):
    """The four ring functions and their plain versions on the same
    tensors; raises unless every output is within the limits.  Returns
    ({function: max abs error of its own outputs: o; dq, dk and dv}, worst
    ulps, worst norm error, worst m/l error, and the backward's own worst
    ulps and norm error)."""
    ring = build_mesh((n,), ("seq",), q.device).ring()
    qs, ks, vs, ps, dos = (ring_shards(x, n) for x in (q, k, v, kv_pad, do))
    errs, worst = {}, [0.0] * 5
    for bidir in (False, True):
        fwd, bwd = ring_pair(bidir)
        got = getattr(ra, fwd)(qs, ks, vs, ps, ring=ring, causal=causal,
                               return_lse=True)
        o, m, l = getattr(ra, fwd + "_ref")(qs, ks, vs, ps, ring=ring,
                                            causal=causal)
        grads = getattr(ra, bwd)(qs, ks, vs, ps, o, m, l, dos, ring=ring,
                                 causal=causal)
        ref = getattr(ra, bwd + "_ref")(qs, ks, vs, ps, o, m, l, dos,
                                        ring=ring, causal=causal)
        ulps_b, norm_b = stack_errors(grads, ref)
        ulps, norm = (max(x, y) for x, y in zip(
            stack_errors([got[0]], [o]), (ulps_b, norm_b)))
        live = m > 0.5 * ra.NEG_INF
        ml = max(rel_max(got[1][live], m[live]), rel_max(got[2], l))
        if not torch.equal(got[1][~live], m[~live]):
            ml = math.inf
        if not (ulps <= RING_MAX_ULPS and norm <= RING_REL_NORM
                and ml <= RING_ML_REL):
            raise AssertionError(f"ring {what} ({'two' if bidir else 'one'}"
                                 f"-way): max err {ulps:.3g} bf16 ulps, rel "
                                 f"norm err {norm:.3g}, m/l rel err {ml:.3g}")
        if bool((~live).any()) and not bool(got[0][~live].any()):
            raise AssertionError(f"ring {what}: dead rows came out zero (the "
                                 f"ring attends uniformly there)")
        abs_err = [float((g.float() - w.float()).abs().max())
                   for g, w in zip([got[0], *grads], [o, *ref])]
        errs[fwd], errs[bwd] = abs_err[0], max(abs_err[1:])
        for i, val in enumerate((ulps, norm, ml, ulps_b, norm_b)):
            worst[i] = max(worst[i], val)
    return (errs, *worst)


def ring_phase(dev, log, seeds: int):
    """Phase 12: the ring functions against their plain versions, each case
    of RING_CASES from ``seeds`` seeds and each of RING_SHAPE_CASES from
    one; the two-way ring against full attention; the no-mask control.  Returns (the worst readings, the launches of this
    drive by function)."""
    worst = {"err": dict.fromkeys(RING_KERNELS, 0.0), "ulps": 0.0,
             "norm": 0.0, "ml": 0.0, "bwd_ulps": 0.0, "bwd_norm": 0.0}
    before = {name: getattr(ra, name).launches for name in RING_KERNELS}
    runs = ([(case + (128,), seed) for seed in range(seeds)
             for case in RING_CASES] + [(case, 0) for case in RING_SHAPE_CASES])
    for (what, b, n, c, causal, pad, d), seed in runs:
        q, k, v, kv_pad, do = ring_inputs(dev, b, n, c, pad,
                                          SEED + 10 * seed + n, d)
        errs, *readings = check_ring_case(q, k, v, kv_pad, do, n, causal,
                                          what)
        for key, val in zip(("ulps", "norm", "ml", "bwd_ulps", "bwd_norm"),
                            readings):
            worst[key] = max(worst[key], val)
        ulps, norm, ml, ulps_b, norm_b = readings
        for name, val in errs.items():
            worst["err"][name] = max(worst["err"][name], val)
        log(f"[12] ring {what} (B {b}, H 8, Dh {d}), seed {seed}: max err "
            f"{ulps:.3g} bf16 ulps, relative norm error {norm:.3g}, m/l "
            f"relative error {ml:.3g} (the backward's dq, dk, dv: "
            f"{ulps_b:.3g} ulps, {norm_b:.3g}); max abs err: " + ", ".join(
                f"{name.replace('ring_attention_', '')} {val:.3g}"
                for name, val in errs.items()))
    log(f"[12] worst over the cases: {worst['ulps']:.3g} bf16 ulps (limit "
        f"{RING_MAX_ULPS}), relative norm error {worst['norm']:.3g} (limit "
        f"{RING_REL_NORM}), m/l {worst['ml']:.3g} (limit {RING_ML_REL}); the "
        f"backward's own: {worst['bwd_ulps']:.3g} ulps, relative norm error "
        f"{worst['bwd_norm']:.3g}")
    drive = {name: getattr(ra, name).launches - before[name]
             for name in RING_KERNELS}
    # the schedule itself: the two-way ring against full attention over the
    # whole sequence (f32, no dead rows), which shares no code with it
    what, b, n, c, causal, pad = RING_TRAIN_CASE
    q, k, v, kv_pad, _ = (x.float() if x.dtype == torch.bfloat16 else x
                          for x in ring_inputs(dev, b, n, c, pad, SEED + 5))
    ring = build_mesh((n,), ("seq",), dev).ring()
    o = ra.ring_attention_fwd_bidir_shard(
        *(ring_shards(x, n) for x in (q, k, v, kv_pad)), ring=ring,
        causal=causal)
    full = fa.flash_attention_fwd_ref(q, k, v, kv_pad, causal)[0]
    err = rel_max(o.transpose(0, 1).reshape(q.shape), full)
    if err > RING_FULL_REL:
        raise AssertionError(f"two-way ring against full attention: "
                             f"relative max error {err:.3g}")
    log(f"[12] two-way ring kernels against full attention ({what}, f32): "
        f"relative max error {err:.3g} (limit {RING_FULL_REL})")
    # the check must tell a wrong attention apart: the plain version
    # without its key-pad mask has to fail it
    q, k, v, kv_pad, _ = ring_inputs(dev, b, n, c, pad, SEED)
    sh = [ring_shards(x, n) for x in (q, k, v, kv_pad)]
    got = ra.ring_attention_fwd_bidir_shard(*sh, ring=ring, causal=causal)
    unmasked = ra.ring_attention_fwd_bidir_shard_ref(
        *sh[:3], torch.zeros_like(sh[3]), ring=ring, causal=causal)[0]
    ulps, norm = stack_errors([got], [unmasked])
    if ulps <= RING_MAX_ULPS and norm <= RING_REL_NORM:
        raise AssertionError("the ring check passes a plain version without "
                             "its key-pad mask")
    log(f"[12] control: the plain version without its key-pad mask reads "
        f"{ulps:.3g} bf16 ulps, relative norm error {norm:.3g} (fails the "
        f"check, as it must)")
    return worst, drive


def ring_launch_counts(n: int, causal: bool, bidir: bool = True):
    """(forward, backward) kernel launches of one ring call, from the
    schedule: per step where any rank sees a live block, the forward
    launches once (a rank's last such step finalizes it) and the backward
    launches a dK/dV and a dQ kernel; the backward adds one landing launch
    per call.  Step s brings block r - s and, two-way, block r + s (not at
    s = 0, nor where it is r - s); a causal block is live when it is not
    after the rank's own."""
    steps = n // 2 + 1 if bidir else n
    busy = set()
    for r in range(n):
        for s in range(steps):
            srcs = {(r - s) % n} | ({(r + s) % n} if bidir and s else set())
            if any(not causal or src <= r for src in srcs):
                busy.add(s)
    return len(busy), 2 * len(busy) + 1


def ring_counts() -> dict:
    """The launch counts of the ring and the flash functions."""
    return ({name: getattr(ra, name).launches for name in RING_KERNELS}
            | {name: getattr(fa, name).launches for name in FLASH_KERNELS})


def zero_counts() -> None:
    for name in RING_KERNELS:
        getattr(ra, name).launches = 0
    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0


def sp_train_compare(dev, seed: int, log):
    """Phase 13: the flagship trained with sequence parallelism on a seq 4
    mesh (the two-way ring kernels, flash elsewhere) against the einsum
    path from the same weights, batch and generator seeds; then an eval
    step on a seq 3 mesh against the einsum path.  Returns (the launch
    counts of the seq 4 run, the worst differences, the run's (cfg, ring
    state, einsum cfg, einsum state, batch))."""
    cfg = serve.flagship_config().replace(
        use_pallas_attention=True, attention_dropout=0.0,
        sequence_parallel=True, ring_attention_impl="pallas")
    t0 = time.perf_counter()
    mesh = build_mesh((RING_SEQ,), ("seq",), dev)
    kmodel = IQ(cfg, serve.FLAGSHIP_VOCAB, mesh).to(dev)
    kstate = create_train_state(cfg, kmodel, seed=seed)
    ecfg = cfg.replace(use_pallas_attention=False, sequence_parallel=False)
    emodel = IQ(ecfg, serve.FLAGSHIP_VOCAB).to(dev)
    emodel.load_state_dict(kmodel.state_dict())
    estate = create_train_state(ecfg, emodel, seed=None)
    batch = make_batch(cfg, serve.FLAGSHIP_VOCAB, BATCH,
                       np.random.RandomState(seed + 200), dev)
    torch.cuda.synchronize()
    t_dec, t_post = cfg.max_q_length, cfg.max_posterior_len
    log(f"[13] seed {seed}: two flagship train states ready in "
        f"{time.perf_counter() - t0:.1f} s; mesh {mesh.shape}: the decoder "
        f"self-attentions (T {t_dec}) ring, the posterior (T {t_post}) and "
        f"context (T {cfg.max_context_len}) encoders and cross-attention "
        f"take flash; einsum path without either")
    theta0 = flat_params(emodel)
    gens = [torch.Generator(dev).manual_seed(seed + 300) for _ in range(2)]
    worst = {"loss": 0.0, "gnorm": 0.0, "param": 0.0}
    zero_counts()
    hop0 = mesh.ring().hop_bytes
    for i, latent_mode in enumerate((False,) * 3 + (True,) * 3):
        if i == 3:
            kstate.reset_optimizer()
            estate.reset_optimizer()
        _, mk = make_train_step(cfg, latent_mode, mesh)(kstate, batch, gens[0])
        _, me = make_train_step(ecfg, latent_mode)(estate, batch, gens[1])
        mk = {n: float(v) for n, v in mk.items()}
        me = {n: float(v) for n, v in me.items()}
        if not all(math.isfinite(v) for v in (*mk.values(), *me.values())):
            raise AssertionError(f"sp train step {i}: non-finite metrics {mk}")
        if latent_mode != (mk["kld"] > 0.0):
            raise AssertionError(f"sp train step {i}: kld {mk['kld']}")
        loss_rel = abs(mk["loss"] - me["loss"]) / abs(me["loss"])
        gnorm_rel = abs(mk["grad_norm"] - me["grad_norm"]) / me["grad_norm"]
        theta_k, theta_e = flat_params(kmodel), flat_params(emodel)
        param_rel = float((theta_k - theta_e).norm()
                          / (theta_e - theta0).norm().clamp_min(1e-30))
        del theta_k, theta_e
        for key, val in zip(worst, (loss_rel, gnorm_rel, param_rel)):
            worst[key] = max(worst[key], val)
        log(f"[13] seed {seed}, {'latent' if latent_mode else 'pretrain'} "
            f"step {i}: loss {mk['loss']:.6g} (einsum {me['loss']:.6g}), "
            f"grad_norm {mk['grad_norm']:.6g} (einsum {me['grad_norm']:.6g});"
            f" relative: loss {loss_rel:.3g}, grad_norm {gnorm_rel:.3g}, "
            f"parameters {param_rel:.3g} of their motion")
    ev_k = make_eval_step(cfg, True, mesh)(kstate, batch, gens[0])
    ev_e = make_eval_step(ecfg, True)(estate, batch, gens[1])
    launches = ring_counts()
    hops = mesh.ring().hop_bytes - hop0
    ev_rel = abs(float(ev_k["loss"]) - float(ev_e["loss"])) / abs(
        float(ev_e["loss"]))
    worst["loss"] = max(worst["loss"], ev_rel)
    # the launches the schedule asks for: per train step the L decoder
    # self-attentions ring (forward, and backward but in the eval step);
    # flash takes the L context-encoder, the L cross- and, in latent mode,
    # the L posterior-encoder attentions
    nl = cfg.num_layers
    f_call, b_call = ring_launch_counts(RING_SEQ, True)
    flash_steps = 3 * 2 * nl + 3 * 3 * nl
    want = {name: 0 for name in RING_KERNELS} | {
        "ring_attention_fwd_bidir_shard": (6 + 1) * nl * f_call,
        "ring_attention_bwd_bidir_shard": 6 * nl * b_call,
        "flash_attention_fwd": flash_steps + 3 * nl,
        "flash_attention_bwd_dkdv": flash_steps,
        "flash_attention_bwd_dq": flash_steps}
    log(f"[13] seed {seed}, eval step: loss {float(ev_k['loss']):.6g} "
        f"(einsum {float(ev_e['loss']):.6g}); launches {launches}; hop bytes "
        f"{hops}")
    if launches != want:
        raise AssertionError(f"sp launch counts {launches}, want {want}")

    # the eval step on an odd ring: seq 3, where the posterior (T 21) and
    # context (T 3) encoders ring, non-causal, and the decoder takes flash
    mesh3 = build_mesh((3,), ("seq",), dev)
    model3 = IQ(cfg, serve.FLAGSHIP_VOCAB, mesh3).to(dev)
    model3.load_state_dict(kmodel.state_dict())
    emodel.load_state_dict(kmodel.state_dict())
    state3 = create_train_state(cfg, model3, seed=None)
    zero_counts()
    ev3 = make_eval_step(cfg, True, mesh3)(
        state3, batch, torch.Generator(dev).manual_seed(seed + 400))
    launches3 = ring_counts()
    ev3_e = make_eval_step(ecfg, True)(
        estate, batch, torch.Generator(dev).manual_seed(seed + 400))
    want3 = {name: 0 for name in launches3} | {
        "ring_attention_fwd_bidir_shard": 2 * nl * ring_launch_counts(
            3, False)[0], "flash_attention_fwd": 2 * nl}
    ev3_rel = abs(float(ev3["loss"]) - float(ev3_e["loss"])) / abs(
        float(ev3_e["loss"]))
    worst["loss"] = max(worst["loss"], ev3_rel)
    log(f"[13] seed {seed}, eval step on seq 3: loss {float(ev3['loss']):.6g}"
        f" (einsum {float(ev3_e['loss']):.6g}), relative {ev3_rel:.3g}; "
        f"launches {launches3}")
    if launches3 != want3:
        raise AssertionError(f"seq 3 launch counts {launches3}, want {want3}")
    del model3, state3
    log(f"[13] seed {seed}: ring path against einsum path, worst over the "
        f"steps: loss {worst['loss']:.3g}, grad_norm {worst['gnorm']:.3g}, "
        f"parameters {worst['param']:.3g} (limits {SP_LOSS_REL}, "
        f"{SP_GNORM_REL}, {SP_PARAM_REL})")
    if not (worst["loss"] <= SP_LOSS_REL and worst["gnorm"] <= SP_GNORM_REL
            and worst["param"] <= SP_PARAM_REL):
        raise AssertionError(f"ring path against einsum path: {worst}")
    return launches, worst, (cfg, kstate, ecfg, estate, batch)


def ring_bounds(b: int, n: int, c: int, kv_pad, causal: bool, h: int = 8,
                d: int = 128) -> dict:
    """{function: (bytes, operations)} of one call: q, k, v and the pads
    read, o, m and l written (forward); q, k, v, o, dO, m, l and the pads
    read, dq, dk and dv written (backward); 4 (forward) or 10 (backward:
    S recomputed, dP, dV, dK, dQ) x D operations per (b, h) and visible
    (query, key) pair of the whole sequence: the causal lower triangle
    less the padded keys, which the live blocks of both schedules cover."""
    act, rows, pad = b * n * c * h * d * 2, b * n * c * h * 4, b * n * c
    pairs = flash_visible_pairs(kv_pad, n * c, causal) * h
    fwd = (4 * act + 2 * rows + pad, 4 * pairs * d)
    bwd = (8 * act + 2 * rows + pad, 10 * pairs * d)
    return {name: fwd if "fwd" in name else bwd for name in RING_KERNELS}


def ring_timings(dev, card, log, cfg, kstate, ecfg, estate, batch):
    """Phase 14: the sequence-parallel train step against the einsum path
    (and its device time by profiler), then each ring function at the
    training and the long shape against its plain version, its bound and
    SDPA.  Returns {function: row numbers for the 6 ring calls of a latent
    train step, and ``long_*`` ones for one call at the long shape}."""
    def steps(state, c, mesh=None):
        step = make_train_step(c, True, mesh)
        g = torch.Generator(dev).manual_seed(1)
        return lambda: step(state, batch, g)

    mesh = kstate.model.mesh
    t_k = [cuda_ms(steps(kstate, cfg, mesh), 3, warmup=1)]
    t_e = [cuda_ms(steps(estate, ecfg), 3, warmup=1)]
    t_e.append(cuda_ms(steps(estate, ecfg), 3, warmup=0))
    t_k.append(cuda_ms(steps(kstate, cfg, mesh), 3, warmup=0))
    k_ms, e_ms = min(t_k), min(t_e)
    log(f"[14] {card}: latent train step b{BATCH}, sequence parallel on seq "
        f"{RING_SEQ}: {k_ms:.2f} ms = {BATCH / k_ms * 1e3:.1f} samples/s "
        f"(runs {t_k}); einsum path {e_ms:.2f} ms = "
        f"{BATCH / e_ms * 1e3:.1f} samples/s (runs {t_e})")
    groups = profile_groups(steps(kstate, cfg, mesh), 1, ("ring_", "flash_"))
    dev_ms = sum(t for _, t in groups.values())
    nk = int(sum(n for n, _ in groups.values()))
    log(f"[14] {card}: profiled sequence-parallel latent train step: device "
        f"kernel time {dev_ms:.2f} ms in {nk} kernels, of which ring kernels "
        f"{groups.get('ring_', (0, 0.0))[1]:.3f} ms in "
        f"{groups.get('ring_', (0, 0.0))[0]:.0f} launches and flash kernels "
        f"{groups.get('flash_', (0, 0.0))[1]:.3f} ms; busy share "
        f"{dev_ms / k_ms:.3f} of the {k_ms:.2f} ms step")

    rows = {}
    calls = cfg.num_layers          # ring calls of one latent train step
    for label, (what, b, n, c, causal, pad) in (("training", RING_TRAIN_CASE),
                                               ("long", RING_LONG_CASE)):
        q, k, v, kv_pad, do = ring_inputs(dev, b, n, c, pad, SEED + 1)
        ring = build_mesh((n,), ("seq",), dev).ring()
        sh = [ring_shards(x, n) for x in (q, k, v, kv_pad, do)]
        o, m, l = ra.ring_attention_fwd_bidir_shard_ref(*sh[:4], ring=ring,
                                                        causal=causal)
        iters = 20 if label == "training" else 5
        allowed = ~kv_pad[:, None, None, :]
        if causal:
            t = n * c
            allowed = allowed & ~torch.ones((t, t), dtype=torch.bool,
                                            device=dev).triu(1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allowed, scale=1.0), iters)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=allowed, scale=1.0)
        dot = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), dot, retain_graph=True), iters)
        bounds = ring_bounds(b, n, c, kv_pad, causal)
        for name in RING_KERNELS:
            fwd = "fwd" in name
            args = sh[:4] if fwd else (*sh[:4], o, m, l, sh[4])
            fn, ref = getattr(ra, name), getattr(ra, name + "_ref")
            h0 = ring.hop_bytes
            fn(*args, ring=ring, causal=causal)
            hops = ring.hop_bytes - h0
            k_ms = cuda_ms(lambda: fn(*args, ring=ring, causal=causal), iters)
            p_ms = cuda_ms(lambda: ref(*args, ring=ring, causal=causal),
                           max(2, iters // 4))
            # device time per call: the ring kernels (by kernel), and the
            # rest (hop and seed copies, layout copies, delta)
            groups = profile_groups(lambda: fn(*args, ring=ring,
                                               causal=causal), 3,
                                    RING_KERNEL_NAMES)
            kn, kdev = (sum(groups.get(k, (0, 0.0))[i]
                            for k in RING_KERNEL_NAMES) for i in (0, 1))
            on, odev = groups.get("other", (0, 0.0))
            nbytes, flops = bounds[name]
            b_ms, b_by = bound(nbytes, flops)
            lib = sdpa_fwd if fwd else sdpa_bwd
            log(f"[14] {card}: {name}, {label} shape ({what}; B {b}, H 8, Dh "
                f"128), per call: kernel {k_ms * 1e3:.1f} us by events, "
                f"device time {kdev * 1e3:.1f} us in {kn:.0f} ring kernel "
                f"launches (+ {odev * 1e3:.1f} us in {on:.0f} other device "
                f"operations: copies), plain {p_ms * 1e3:.1f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}), SDPA "
                f"{'forward' if fwd else 'backward'} {lib * 1e3:.1f} us;"
                f" hops move {hops} bytes; by kernel: " + ", ".join(
                    f"{k} {groups[k][1] * 1e3:.1f} us in {groups[k][0]:.0f}"
                    for k in RING_KERNEL_NAMES if k in groups))
            if label == "training":
                rows[name] = {"ms": calls * k_ms, "plain_ms": calls * p_ms,
                              "bound_ms": calls * b_ms, "bound_by": b_by,
                              "library_ms": calls * lib,
                              "device_ms": calls * kdev,
                              "launches_per_call": kn}
            else:           # one call at the long shape
                rows[name].update(long_ms=k_ms, long_device_ms=kdev,
                                  long_plain_ms=p_ms, long_bound_ms=b_ms,
                                  long_bound_by=b_by, long_library_ms=lib)
    return rows


def mma_code(lib_path: str, report: str) -> None:
    """Phase 1: the compiler's registers and spills of the ring and flash
    kernels, of the decode kernels' split-K product and fused residual
    + LayerNorm, and of the cluster product's kernels and the kernels
    beside them (with their dynamic shared memory) and of
    int8_wgmma_kernel; raises unless the machine code of each bf16
    tensor-core kernel (RING_MMA, FLASH_MMA, CLUSTER_MMA, INT8_KERNEL) has
    tensor-core products (HMMA or HGMMA; HGMMA for INT8_KERNEL), and unless
    ptxas reports no spills for the flash, cluster and int8 kernels (the ring
    forward's registers are capped for 3 blocks per SM, and it spills a
    few bytes by design)."""
    kernels = RING_MMA + FLASH_MMA + CLUSTER_MMA + (INT8_KERNEL,)
    watched = ("ring_", "flash_", "gemm_partial_kernel", "residual_ln_kernel",
               *CLUSTER_MMA, *CLUSTER_OTHER, INT8_KERNEL)
    for entry in report.split("Compiling entry function")[1:]:
        name = entry.split("'")[1]
        if any(w in name for w in watched):
            used = re.search(r"Used (\d+) registers[^\n]*", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            log(f"    ptxas {name}: {used.group(0) if used else '?'}; "
                f"spill stores {spill.group(1) if spill else '?'} bytes")
            if any(k in name for k in FLASH_MMA + CLUSTER_MMA
                   + (INT8_KERNEL,)) and not (spill and spill.group(1) == "0"):
                raise AssertionError(f"{name} spills (or ptxas did not say)")
    for w_i8 in (False, True):
        log(f"    cluster product, {'int8' if w_i8 else 'bf16'} weights: "
            f"{decode_stream.cluster_smem(w_i8)} bytes of dynamic shared "
            f"memory a block ({decode_stream.cluster_smem(w_i8, 2)} with "
            f"two partial tiles)")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log(f"    cuobjdump not found beside nvcc: SASS not read")
        return
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    found = set()
    for fn in out.stdout.split("Function : ")[1:]:
        name = fn.split()[0]
        if not any(w in name for w in watched):
            continue
        # an instruction's text, its guard predicate (@P0, @!P1) dropped
        code = [re.sub(r"^@!?U?P\w+\s+", "",
                       ln.split(";")[0].split("*/")[-1].strip())
                for ln in fn.splitlines() if "MMA" in ln]
        mma = [op for op in code if op.startswith(("HMMA", "HGMMA"))]
        log(f"    SASS {name}: {len(mma)} tensor-core products "
            f"{sorted({op.split()[0] for op in mma})}"
            + (f", e.g. '{mma[0]}'" if mma else ""))
        kernel = next((k for k in kernels if k in name), None)
        if kernel is not None:
            if not mma:
                raise AssertionError(f"{name} has no HMMA/HGMMA instruction")
            if kernel == INT8_KERNEL and not any(
                    op.startswith("HGMMA") for op in mma):
                raise AssertionError(f"{name} has no HGMMA instruction")
            found.add(kernel)
    if found != set(kernels):
        raise AssertionError(f"no SASS read for {set(kernels) - found}")


def kernel_split(groups: dict) -> dict:
    """{short kernel name: (launches, device us) per call} of
    profile_groups' reading."""
    out = {}
    for name, (n, ms) in groups.items():
        short = re.sub(r"^void |^bvq::|<.*$|\(.*$", "", name)
        short = short.split("::")[-1]
        m, t = out.get(short, (0.0, 0.0))
        out[short] = (round(m + n, 3), round(t + ms * 1e3, 2))
    return out


def host_ms(fn, calls: int = 5) -> float:
    """Host time per call of ``fn``, in ms: ``calls`` calls timed by the
    host's clock up to the last launch, before the card has caught up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def decode_times(dev, card, log):
    """--decode-times-only: rows 1, 2, 4a and 4b alone, each by events, by
    host clock and by profiler (device time, split by kernel, launches per
    call), at the shapes of phases 4 and 11: the stack at b64 pos 25 and at
    b512 (bf16 and int8 weights), the fused head (int8 and bf16; warm, and
    with a cold L2: L2_FLUSH_BYTES written before each call, events around
    the head alone), and self_attn_step (pos 25) and cross_ffn_step at b64
    and b256 (the six layers' weights cycled).  Uses only the port's public
    functions, so the same script times an older tree."""
    cfg, model, latent = serve.build_model(seed=SEED, stream=True, device=dev)
    pl_cfg, pl_model = per_layer_model(model, cfg, dev)
    with torch.inference_mode():
        images, context = serve.make_requests(
            np.random.RandomState(SEED + 100), BATCH, cfg, dev)
        plan = model.prepare_decode(images, context, cfg.max_decode_length,
                                    latent, False, cfg.decode_z_source,
                                    torch.Generator(dev).manual_seed(SEED))
        lmax = cfg.max_decode_length + 1
        nl, nh, dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
        g = torch.Generator(dev).manual_seed(SEED + 1)
        caches = tuple((torch.randn((nl, nh, lmax, BATCH, dh), generator=g,
                                    device=dev) * 2.0).to(torch.bfloat16)
                       for _ in range(2))
        x = (torch.randn((BATCH, cfg.hidden_dim), generator=g, device=dev)
             * 2.0).to(torch.bfloat16)
        for b in (BATCH,) + STACK_BATCHES[-1:]:
            for quantized in (False, True):
                if b == BATCH:
                    args, kw = stack_args(plan, x, caches, quantized, None, 25)
                else:
                    args, kw = stack_batch_args(plan, b, lmax, quantized, 25,
                                                SEED + b, dev)
                fn = lambda: decode_stream.decode_stack_step(*args, **kw)
                ev, dv, hs = cuda_ms(fn, 20), device_ms(fn, 5), host_ms(fn)
                kinds = kernel_split(profile_groups(fn, 3))
                wbytes = nbytes(*(args[i] for i in (3, 4, 7, 8, 12, 14)),
                                *(kw["weight_scales"] or ()))
                log(f"[decode] {card}: decode_stack_step "
                    f"{'int8' if quantized else 'bf16'} weights b{b} pos 25: "
                    f"{ev * 1e3:.1f} us by events, {hs * 1e3:.1f} us of host "
                    f"time, {dv * 1e3:.1f} us of device time "
                    f"({wbytes / dv / 1e9:.3f} TB/s of weights), "
                    f"{sum(n for n, _ in kinds.values()):.0f} device "
                    f"launches per call; per kernel (launches, us): {kinds}")
                del args, kw
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)
        for quantized in (True, False):
            h = head_args(model, quantized)
            fn = lambda: run_head(h, x, kernel=True)
            ev, dv, hs = cuda_ms(fn, 50), device_ms(fn, 5), host_ms(fn, 30)
            cold = cold_ms(fn, flush, 30)
            kinds = kernel_split(profile_groups(fn, 5))
            log(f"[decode] {card}: head_argmax "
                f"{'int8' if quantized else 'bf16'} b{BATCH}: "
                f"{ev * 1e3:.1f} us by events, {hs * 1e3:.1f} us of host "
                f"time, {dv * 1e3:.1f} us of device time; L2 cold "
                f"({L2_FLUSH_BYTES >> 20} MiB written before each call): "
                f"{cold[0] * 1e3:.1f} us by events around the call, "
                f"{cold[1] * 1e3:.1f} us of device time; "
                f"{sum(n for n, _ in kinds.values()):.0f} device launches "
                f"per call; per kernel (launches, us): {kinds}")
        del flush
        lws = pl_model.decoder.layer_weights()
        for bt in LAYER_BATCHES:
            cs = [layer_case(pl_cfg, bt, SEED + 3 + l, dev)
                  for l in range(len(lws))]
            fn = cycled([lambda w=w, c=c: decode_layer.self_attn_step(
                *self_args(w, c["x"], c["ck"], c["cv"], LAYER_TIME_POS, nh))
                for w, c in zip(lws, cs)])
            ev, dv = cuda_ms(fn, 60), device_ms(fn, len(lws))
            hs = host_ms(fn, 30)
            kinds = kernel_split(profile_groups(fn, len(lws)))
            log(f"[decode] {card}: self_attn_step b{bt} pos "
                f"{LAYER_TIME_POS}: {ev * 1e3:.1f} us by events, "
                f"{hs * 1e3:.1f} us of host time, {dv * 1e3:.1f} us of device "
                f"time, {sum(n for n, _ in kinds.values()):.0f} device "
                f"launches per call; per kernel (launches, us): {kinds}")
            del cs
        for bt in LAYER_BATCHES:
            cs = [layer_case(pl_cfg, bt, SEED + 3 + l, dev)
                  for l in range(len(lws))]
            fn = cycled([lambda w=w, c=c: decode_layer.cross_ffn_step(
                *cross_args(w, c["x"], c["xk"], c["xv"], c["src_pad"]), nh)
                for w, c in zip(lws, cs)])
            ev, dv = cuda_ms(fn, 60), device_ms(fn, len(lws))
            hs = host_ms(fn, 30)
            kinds = kernel_split(profile_groups(fn, len(lws)))
            log(f"[decode] {card}: cross_ffn_step b{bt}: {ev * 1e3:.1f} us "
                f"by events, {hs * 1e3:.1f} us of host time, {dv * 1e3:.1f} "
                f"us of device time, "
                f"{sum(n for n, _ in kinds.values()):.0f} device launches "
                f"per call; per kernel (launches, us): {kinds}")


def int8_times(dev, card, log):
    """--int8-times-only: int8_matmul alone (bf16 x, seed-made weights) at
    both INT8_SHAPES, the weight copies cycled so that they do not sit in
    L2: events, host clock, and profiler device time split by kernel, with
    the bound; on a tree that picks a tiling (``tma_columns``), also
    each of its tilings forced (0: the split-K product).  Uses only
    functions older trees have."""
    g = torch.Generator(dev).manual_seed(SEED + 5)
    pick = getattr(i8mm, "tma_columns", None)
    # a second of matrix products first, and a first profiler session, so
    # that the first reading takes neither the card's clocks on their way
    # up nor the profiler's start
    warm = torch.randn((4096, 4096), generator=g, device=dev)
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        warm @ warm
        torch.cuda.synchronize()
    profile_groups(lambda: warm @ warm, 2)
    del warm
    for what, m, k, n in INT8_SHAPES:
        x = (torch.randn((m, k), generator=g, device=dev) * 2.0).to(
            torch.bfloat16)
        w8, s = i8mm.quantize_int8(torch.randn((k, n), generator=g,
                                               device=dev) * k ** -0.5)
        copies = max(1, math.ceil(60e6 / nbytes(w8)))
        w8s = [w8.clone() for _ in range(copies)]
        b_ms, b_by = bound(*int8_bound(x, w8, s))
        for forced in ((None,) if pick is None else (None, 128, 64, 0)):
            if forced is not None:
                i8mm.tma_columns = lambda *a, bn=forced, **kw: bn
            fn = cycled([lambda w=w: i8mm.int8_matmul(x, w, s) for w in w8s])
            try:
                ulps, norm = stack_errors([fn()], [i8mm.int8_matmul_ref(
                    x, w8s[0], s)])
                ev, hs = cuda_ms(fn, 200), host_ms(fn, 50)
                for _ in range(3):  # the profiler may drop every record
                    groups = profile_groups(fn, copies)
                    if groups:
                        break
            finally:
                if pick is not None:
                    i8mm.tma_columns = pick
            dv = sum(t for _, t in groups.values())
            tiling = ("as picked" if forced is None else
                      f"forced {forced}-column tiles" if forced else
                      "forced split-K")
            log(f"[int8] {card}: int8_matmul {what} (M {m}, K {k}, N {n}), "
                f"{tiling}: {ev * 1e3:.1f} us by events, {hs * 1e3:.1f} us "
                f"of host time, {dv * 1e3:.1f} us of device time, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}); max err {ulps:.3g} bf16 "
                f"ulps, relative norm error {norm:.3g}; per kernel "
                f"(launches, us): {kernel_split(groups)}")
        del w8s


# ---------------------------------------------------------------------------
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--flash-seeds", type=int, default=3,
                        help="seeds of each flash-attention check case")
    parser.add_argument("--train-seeds", type=int, default=1,
                        help="weight and batch seeds of the training "
                        "comparison (more seeds take readings for limits)")
    parser.add_argument("--layer-seeds", type=int, default=1,
                        help="input seeds of the per-layer kernel and "
                        "int8_matmul checks (more seeds take readings for "
                        "limits)")
    parser.add_argument("--ring-seeds", type=int, default=1,
                        help="input seeds of each ring-attention check case")
    parser.add_argument("--sp-seeds", type=int, default=1,
                        help="weight and batch seeds of the "
                        "sequence-parallel training comparison")
    parser.add_argument("--flash-times-only", action="store_true",
                        help="build, take phase 7's flash kernel times and "
                        "stop (no result line): to compare two trees' "
                        "kernels on one card, run in turns from each tree")
    parser.add_argument("--decode-times-only", action="store_true",
                        help="build, time the decode stack step, the fused "
                        "head (also with a cold L2), self_attn_step and "
                        "cross_ffn_step alone (events and profiler) and "
                        "stop (no result line); runs from an older tree too")
    parser.add_argument("--int8-times-only", action="store_true",
                        help="build, time int8_matmul alone at both of its "
                        "shapes (events, host clock and profiler; each "
                        "tiling where the tree has a choice) and stop (no "
                        "result line); runs from an older tree too")
    opts = parser.parse_args(argv)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this check "
                           "needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")
    with open(lib_path + ".log") as f:
        report = f.read()
    spills = [m.group(0) for m in re.finditer(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
        if m.group(1) != "0" or m.group(2) != "0"]
    log(f"    ptxas: {report.count('Used ')} kernels reported, spilling: "
        f"{spills or 'none'}")
    if opts.flash_times_only:
        flash_timings(dev, card, log)
        return
    if opts.decode_times_only:
        decode_times(dev, card, log)
        return
    if opts.int8_times_only:
        int8_times(dev, card, log)
        return
    mma_code(lib_path, report)

    # ---- the flagship model, seed-made weights
    t0 = time.perf_counter()
    cfg, model, latent = serve.build_model(seed=SEED, stream=True, device=dev)
    if not model.fused_head_engaged(with_probe=False):
        raise AssertionError("the flagship serving config must take the "
                             "fused int8 head")
    log(f"    flagship model ready in {time.perf_counter() - t0:.1f} s: "
        f"hidden {cfg.hidden_dim}, layers {cfg.num_layers}, heads "
        f"{cfg.num_heads}, FFN {cfg.pwffn_dim}, vocab {model.vocab_size}, "
        f"{cfg.dtype}, head {model.head_dtype}")
    # the same weights on the per-layer decode path (outside inference mode,
    # so its regrouped weights are built once and kept)
    pl_cfg, pl_model = per_layer_model(model, cfg, dev)

    with torch.inference_mode():
        # ---- 2. kernels against their plain versions at flagship shapes
        gen = torch.Generator(dev).manual_seed(SEED)
        images, context = serve.make_requests(
            np.random.RandomState(SEED + 100), BATCH, cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = model.prepare_decode(images, context, cfg.max_decode_length,
                                    latent, False, cfg.decode_z_source, gen)
        torch.cuda.synchronize()
        log(f"    first prepare_decode (builds the model's weight stacks "
            f"and fused head, and first-call setup) "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
        lmax = cfg.max_decode_length + 1
        nl, nh, dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
        g = torch.Generator(dev).manual_seed(SEED + 1)
        caches = tuple((torch.randn((nl, nh, lmax, BATCH, dh), generator=g,
                                    device=dev) * 2.0).to(torch.bfloat16)
                       for _ in range(2))
        x = (torch.randn((BATCH, cfg.hidden_dim), generator=g, device=dev)
             * 2.0).to(torch.bfloat16)
        key_pad = torch.rand((BATCH, lmax), generator=g, device=dev) < 0.3
        key_pad[:, 0] = True
        stack_err = 0.0
        x_outs = []
        for quantized in (False, True):
            for pos in POSITIONS:
                for kp in ((None, key_pad) if pos in (25, 50) else (None,)):
                    args, kw = stack_args(plan, x, caches, quantized, kp, pos)
                    got = decode_stream.decode_stack_step(*args, **kw)
                    want = decode_stream.decode_stack_step_ref(*args, **kw)
                    what = (f"{'int8' if quantized else 'bf16'} pos {pos}"
                            f"{' key_pad' if kp is not None else ''}")
                    err, ulps, rel_norm = check_stack(got, want, what)
                    stack_err = max(stack_err, err)
                    x_outs.append(got[0])
                    log(f"[2] decode_stack_step {what}: max |x_out err| "
                        f"{err:.4g} (max |x_out| "
                        f"{float(want[0].float().abs().max()):.4g}); worst "
                        f"over x, k, v: max err {ulps:.3g} bf16 ulps, "
                        f"relative norm error {rel_norm:.3g}")
        # the check must tell a wrong stack apart: the plain version of the
        # same stack without its last layer has to fail it
        args, kw = stack_args(plan, x, caches, False, None, 25)
        got = decode_stream.decode_stack_step(*args, **kw)
        short_args, short_kw = without_last_layer(args, kw)
        short = decode_stream.decode_stack_step_ref(*short_args, **short_kw)
        ulps, rel_norm = stack_errors(got[:1], short[:1])
        if ulps <= STACK_MAX_ULPS and rel_norm <= STACK_REL_NORM:
            raise AssertionError("the stack check passes a plain version "
                                 "with a layer left out")
        log(f"[2] control: the plain version without its last layer reads "
            f"{ulps:.3g} bf16 ulps, relative norm error {rel_norm:.3g} "
            f"(fails the check, as it must)")
        # the launch sequence per call, and b128 and b512 on the same limits
        for quantized in (False, True):
            wt = "int8" if quantized else "bf16"
            args, kw = stack_args(plan, x, caches, quantized, key_pad, 25)
            want_kernels = stack_kernels(args[3].shape[0])
            launches_per_call(
                lambda: decode_stream.decode_stack_step(*args, **kw),
                want_kernels, f"decode_stack_step {wt} b{BATCH}")
            for b in STACK_BATCHES:
                args, kw = stack_batch_args(plan, b, lmax, quantized, 25,
                                            SEED + b, dev)
                got = decode_stream.decode_stack_step(*args, **kw)
                want = decode_stream.decode_stack_step_ref(*args, **kw)
                what = f"{wt} b{b} pos 25 key_pad"
                err, ulps, rel_norm = check_stack(got, want, what)
                stack_err = max(stack_err, err)
                launches_per_call(
                    lambda: decode_stream.decode_stack_step(*args, **kw),
                    want_kernels, f"decode_stack_step {what}")
                log(f"[2] decode_stack_step {what}: max |x_out err| "
                    f"{err:.4g}; worst over x, k, v: max err {ulps:.3g} bf16 "
                    f"ulps, relative norm error {rel_norm:.3g}")
                del args, kw, got, want
        log(f"[2] decode_stack_step: kernels per call {want_kernels} "
            f"and nothing else, at b{BATCH} and "
            f"{', '.join(f'b{b}' for b in STACK_BATCHES)}, bf16 and int8 "
            f"weights (profiler)")
        head_err = 0.0
        hx = torch.cat(x_outs[:4])[:BATCH * 2]
        for quantized in (True, False):
            h = head_args(model, quantized)
            tok = run_head(h, hx, kernel=True)
            ref = run_head(h, hx, kernel=False)
            short = check_head(tok, head_logits(h, hx),
                               "int8" if quantized else "bf16")
            head_err = max(head_err, short)
            log(f"[2] head_argmax {'int8' if quantized else 'bf16'}: "
                f"{int((tok == ref).sum())}/{tok.numel()} equal to the plain "
                f"argmax, largest logit shortfall {short:.3g}")
            launches_per_call(lambda: run_head(h, hx, kernel=True),
                              HEAD_KERNELS, "head_argmax")
            # planted tie: column c2 repeats c1 in another chunk, and both
            # outrank every other column; the first index must win
            c1, c2 = 100, 5000
            w, b = h["w"].clone(), h["b"].clone()
            w[:, c2] = w[:, c1]
            b[c1] = b[c2] = 1e4
            tie = dict(h, w=w, b=b)
            if quantized:
                s = h["scales"].clone()
                s[0, c2] = s[0, c1]
                tie["scales"] = s
            tok = run_head(tie, hx, kernel=True)
            if not bool((tok == c1).all()):
                raise AssertionError(f"head_argmax tie: got "
                                     f"{sorted(set(tok.tolist()))}, want {c1}")
            log(f"[2] head_argmax {'int8' if quantized else 'bf16'} planted "
                f"tie: all rows pick column {c1}; kernels per call "
                f"{HEAD_KERNELS} and nothing else (profiler)")

        # ---- 3. the serving path
        decode_stream.decode_stack_step.launches = 0
        decode_head.head_argmax.launches = 0
        rounds = serve.serve_rounds(cfg, model, latent, BATCH, ROUNDS, SEED,
                                    dev, log=lambda m: log("[3] " + m))
        launches = {"decode_stack_step": decode_stream.decode_stack_step.launches,
                    "head_argmax": decode_head.head_argmax.launches}
        steps = cfg.max_decode_length + 1
        for r in rounds:
            t = r["tokens"]
            if tuple(t.shape) != (BATCH, steps):
                raise AssertionError(f"tokens shape {tuple(t.shape)}")
            if not (int(t.min()) >= 0 and int(t.max()) < model.vocab_size):
                raise AssertionError("token ids outside the vocab")
        if launches != {k: steps * ROUNDS for k in launches}:
            raise AssertionError(f"launch counts {launches}, want "
                                 f"{steps * ROUNDS} each")
        log(f"[3] {ROUNDS} rounds: tokens [{BATCH}, {steps}] in [0, "
            f"{model.vocab_size}), launches {launches}")
        # one more round under the profiler: per stack call one self- and
        # one cross-attention kernel a layer
        calls = decode_stream.decode_stack_step.launches
        groups = {}
        for name, (n, _) in profile_groups(lambda: serve.serve_rounds(
                cfg, model, latent, BATCH, 1, SEED, dev, log=lambda m: None),
                1).items():
            fam = kernel_family(name, ("self_attn_kernel", "cross_attn_kernel"))
            groups[fam] = groups.get(fam, 0.0) + n
        calls = (decode_stream.decode_stack_step.launches - calls) / 2
        layers = cfg.num_layers
        attn = [groups.get(k, 0.0) / layers
                for k in ("self_attn_kernel", "cross_attn_kernel")]
        if calls != steps or not all(0 < a <= calls for a in attn):
            raise AssertionError(f"served round: {calls} decode_stack_step "
                                 f"calls; kernels {groups}")
        log(f"[3] a profiled round: {calls:.0f} decode_stack_step calls, "
            f"{attn[0]:.0f} / {attn[1]:.0f} self- / cross-attention launches "
            f"a layer")

        # teacher-forced replay of round 0: the kernel path re-run step by
        # step, each kernel call held against its plain version on the
        # same inputs, and each emitted token against the plain head
        r0 = rounds[0]
        gen = torch.Generator(dev).manual_seed(r0["z_seed"])
        plan = model.prepare_decode(r0["images"], r0["context"],
                                    cfg.max_decode_length, latent, False,
                                    cfg.decode_z_source, gen)
        caches = model.decoder.init_cache(BATCH, steps, dev)[0]
        emitted = r0["tokens"].to(dev)
        token = torch.full((BATCH,), PAD, dtype=torch.int32, device=dev)
        same, replay_err, replay_ulps, replay_norm = 0, 0.0, 0.0, 0.0
        for pos in range(steps):
            x_t = model.embed_tokens(token[:, None])
            if pos == 0:
                x_t = x_t + plan["inject"][:, None]
            x_t = (x_t + model.decoder.timing[pos].to(x_t.dtype))[:, 0]
            args, kw = stack_args(plan, x_t.contiguous(), caches, False,
                                  None, pos)
            got = decode_stream.decode_stack_step(*args, **kw)
            want = decode_stream.decode_stack_step_ref(*args, **kw)
            err, ulps, rel_norm = check_stack(got, want, f"replay pos {pos}")
            replay_err = max(replay_err, err)
            replay_ulps = max(replay_ulps, ulps)
            replay_norm = max(replay_norm, rel_norm)
            caches[0][:, :, pos] = got[1]
            caches[1][:, :, pos] = got[2]
            h = plan["head"]
            tok = run_head(h, got[0], kernel=True)
            check_head(emitted[:, pos], head_logits(h, got[0]),
                       f"replay pos {pos}")
            same += int((tok == emitted[:, pos]).sum())
            token = emitted[:, pos]
        log(f"[3] replay of round 0: {steps} steps within tolerance (max "
            f"|x_out err| {replay_err:.4g}; worst over x, k, v: max err "
            f"{replay_ulps:.3g} bf16 ulps, relative norm error "
            f"{replay_norm:.3g}); {same}/{BATCH * steps} replayed tokens "
            f"equal to the served ones")
        stack_err = max(stack_err, replay_err)

        # ---- 4. timing
        plain_model = IQ(cfg.replace(use_stream_decode=False),
                         model.vocab_size)
        plain_model.load_state_dict(model.state_dict())
        cast_to_compute_dtype_(plain_model)
        plain_model = plain_model.to(dev).eval()
        images, context = r0["images"], r0["context"]

        def decode_fn(m):
            return lambda: m.decode_greedy(
                images, context, cfg.max_decode_length, latent,
                with_probe=False, z_source=cfg.decode_z_source,
                generator=torch.Generator(dev).manual_seed(1))

        t_kernel = [cuda_ms(decode_fn(model), 3, warmup=1)]
        t_plain = [cuda_ms(decode_fn(plain_model), 3, warmup=1)]
        t_plain.append(cuda_ms(decode_fn(plain_model), 3, warmup=0))
        t_kernel.append(cuda_ms(decode_fn(model), 3, warmup=0))
        kernel_ms, plain_ms = min(t_kernel), min(t_plain)
        log(f"[4] {card}: decode b{BATCH} ({steps} steps) kernel path "
            f"{kernel_ms:.2f} ms = {BATCH / kernel_ms * 1e3:.1f} q/s "
            f"(runs {t_kernel}); plain path {plain_ms:.2f} ms = "
            f"{BATCH / plain_ms * 1e3:.1f} q/s (runs {t_plain})")

        def prelude():
            return model.prepare_decode(
                images, context, cfg.max_decode_length, latent, False,
                cfg.decode_z_source, torch.Generator(dev).manual_seed(1))

        prelude_ms = cuda_ms(prelude, 5, warmup=1)
        log(f"[4] {card}: prepare_decode b{BATCH} (ResNet-18, context "
            f"encoder, latent, cross K/V; weight stacks kept) "
            f"{prelude_ms:.2f} ms")
        plan = prelude()
        timings = {}
        for quantized in (False, True):
            args, kw = stack_args(plan, x, caches, quantized, None, 25)
            k = cuda_ms(lambda: decode_stream.decode_stack_step(*args, **kw),
                        20)
            dms = launches_per_call(
                lambda: decode_stream.decode_stack_step(*args, **kw),
                stack_kernels(args[3].shape[0]), "decode_stack_step")
            p = cuda_ms(lambda: decode_stream.decode_stack_step_ref(*args,
                                                                    **kw), 5)
            timings[("stack", quantized)] = (k, p, stack_bound(args, kw, 25),
                                             dms)
            wbytes = nbytes(*(args[i] for i in (3, 4, 7, 8, 12, 14)),
                            *(kw["weight_scales"] or ()))
            log(f"[4] {card}: decode_stack_step "
                f"{'int8' if quantized else 'bf16'} weights, b{BATCH} pos 25:"
                f" kernel {k * 1e3:.1f} us by events, {dms * 1e3:.1f} us of "
                f"device time ({sum(stack_kernels(args[3].shape[0]).values())} "
                f"kernels, profiler; "
                f"{wbytes / dms / 1e9:.3f} TB/s of {wbytes / 1e6:.1f} MB of "
                f"weights against {HBM_BYTES_PER_S / 1e12:.2f}), plain "
                f"{p * 1e3:.1f} us")
        hx = x_outs[0]
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)
        for quantized in (True, False):
            h = head_args(model, quantized)
            k = cuda_ms(lambda: run_head(h, hx, kernel=True), 50)
            dms = device_ms(lambda: run_head(h, hx, kernel=True), 5)
            p = cuda_ms(lambda: run_head(h, hx, kernel=False), 50)
            cold = cold_ms(lambda: run_head(h, hx, kernel=True), flush, 20)
            timings[("head", quantized)] = (k, p, head_bound(h, hx), dms)
            timings[("head cold", quantized)] = cold
            log(f"[4] {card}: head_argmax {'int8' if quantized else 'bf16'}"
                f" b{BATCH} V {h['w'].shape[1]}: kernel {k * 1e3:.1f} us by "
                f"events, {dms * 1e3:.1f} us of device time (profiler), "
                f"plain {p * 1e3:.1f} us (weights L2-resident across "
                f"repeats); L2 cold ({L2_FLUSH_BYTES >> 20} MiB written "
                f"before each call): {cold[0] * 1e3:.1f} us by events around "
                f"the call, {cold[1] * 1e3:.1f} us of device time")
        del flush

        # ---- 8-11. the per-layer decode path and int8_matmul
        layer_worst = layer_phase(dev, log, pl_model, opts.layer_seeds)
        layer_launch, replay = layer_path_phase(
            dev, log, pl_cfg, pl_model, latent, images, context,
            r0["z_seed"])
        for name in LAYER_KERNELS:
            note(layer_worst, name, [replay[name][k]
                                     for k in ("err", "ulps", "norm")])
        int8_cases, int8_launches, int8_worst = int8_phase(
            dev, log, model, opts.layer_seeds)
        layer_times = layer_timings(
            dev, card, log, pl_cfg, pl_model, plain_model, latent, images,
            context, int8_cases)
        del plain_model, pl_model, int8_cases

    # ---- 5. the flash kernels against their plain versions
    flash_worst = flash_phase(dev, log, opts.flash_seeds)
    # ---- 6. training; the flash launch counts are read around each run
    for i in range(opts.train_seeds):
        launches_i, _, run_i = train_compare(dev, SEED + i, log)
        if i == 0:
            train_launches, run = launches_i, run_i
        del run_i
    # ---- 7. times
    train_times(dev, card, log, *run)
    del run
    flash_totals = flash_timings(dev, card, log)

    # ---- 12. the ring functions against their plain versions
    ring_worst, ring_drive = ring_phase(dev, log, opts.ring_seeds)
    # ---- 13. sequence-parallel training; the launch counts are read
    # around each run
    for i in range(opts.sp_seeds):
        launches_i, _, run_i = sp_train_compare(dev, SEED + i, log)
        if i == 0:
            sp_launches, run = launches_i, run_i
        del run_i
    # ---- 14. times
    ring_rows = ring_timings(dev, card, log, *run)
    del run

    # decode kernels in their main-path forms: bf16 stack weights, int8
    # head; one call each (the stack at pos 25).  The flash kernels: the
    # 24 calls of one latent train step.  No single PyTorch call computes
    # the decode step or the fused head; the backward rows share the plain
    # backward's and SDPA's backward's times (dq, dk and dv in one call).
    kernels = []
    for name, src, tpu, key, err in (
            ("decode_stack_step", STACK_SRC, STACK_TPU, ("stack", False),
             stack_err),
            ("head_argmax", HEAD_SRC, HEAD_TPU, ("head", True), head_err)):
        k_ms, p_ms, (moved, flops), d_ms = timings[key]
        b_ms, b_by = bound(moved, flops)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": launches[name],
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "device_ms": d_ms})
        if name == "head_argmax":
            kernels[-1]["cold_ms"], kernels[-1]["cold_device_ms"] = \
                timings[("head cold", True)]
    for name in FLASH_KERNELS:
        tot = flash_totals[name]
        row = {"name": name, "kernel": FLASH_MMA[FLASH_KERNELS.index(name)],
               "route": "cuda", "source": FLASH_SRC,
               "replaces": FLASH_TPU[name], "launches": train_launches[name],
               "max_abs_err": flash_worst["err"][name], "ms": tot["ms"],
               "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
               "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
               **{k: v for k, v in tot.items()
                  if k in ("device_ms", "library_device_ms") or k.startswith("long_")}}
        if not name.endswith("fwd"):
            row["shared"] = ("plain_ms and library_ms: one backward call "
                             "computing dq, dk and dv")
        kernels.append(row)
    # the per-layer kernels: one call at b64 pos 25 (weights of the six
    # layers cycled), launches of the greedy b64 decode; int8_matmul: one
    # call at the vocab-head shape (ffn_in_*: FFN in at beam width),
    # launches of its phase-10 drive.  No single PyTorch call computes a
    # per-layer step.
    for name in LAYER_KERNELS:
        k_ms, p_ms, b_ms, b_by, d_ms = layer_times[(name, BATCH)]
        kernels.append({"name": name, "route": "cuda", "source": LAYER_SRC,
                        "replaces": LAYER_TPU[name],
                        "launches": layer_launch[name],
                        "max_abs_err": layer_worst[name]["err"], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "device_ms": d_ms})
    k_ms, p_ms, b_ms, b_by, lib_ms, d_ms = layer_times[(
        "int8_matmul", INT8_SHAPES[0][0])]
    f_ms, fp_ms, fb_ms, _, flib_ms, fd_ms = layer_times[(
        "int8_matmul", INT8_SHAPES[1][0])]
    kernels.append({"name": "int8_matmul", "kernel": INT8_KERNEL,
                    "route": "cuda", "source": INT8_SRC, "replaces": INT8_TPU,
                    "launches": int8_launches,
                    "max_abs_err": int8_worst["err"], "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "device_ms": d_ms,
                    "ffn_in_ms": f_ms, "ffn_in_device_ms": fd_ms,
                    "ffn_in_plain_ms": fp_ms, "ffn_in_bound_ms": fb_ms,
                    "ffn_in_library_ms": flib_ms})
    # the ring functions: the 6 ring calls of one latent train step at the
    # training shape (B 64, T 20 on seq 4, causal); launches of the
    # sequence-parallel run (the two-way pair) or, for the one-way pair,
    # which the model does not install, of their phase-12 drive.  The
    # backward rows' library time is SDPA's backward (dq, dk and dv).
    for name in RING_KERNELS:
        row = {"name": name, "route": "cuda", "source": RING_SRC,
               "replaces": RING_TPU[name],
               "launches": sp_launches[name] or ring_drive[name],
               "max_abs_err": ring_worst["err"][name], **ring_rows[name]}
        if not sp_launches[name]:
            row["launches_from"] = "phase 12 drive (not on the model path)"
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
