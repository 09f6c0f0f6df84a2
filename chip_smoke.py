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
   port never calls); the ``kernels`` line carries both shapes;
15. trains the flagship through the port's train CLI
   (``blt_vqg_tpu_torch.cli.train_iq.main``) on a synthetic packed
   dataset written with numpy (512 questions over 128 images of 224x224x3
   uint8, 128 validation questions, vocab 12,000): ``use_pallas_attention``
   without attention dropout, ``use_pallas_decode``, 2 pretrain and 4
   latent steps in dispatches of 2, 1, 1 and 2 (``make_multi_step``),
   validations with the latent report at steps 3 and 6 and a final one,
   checkpoints every 2 steps; checks the losses, the kld on each side of
   the boundary, the Adam restart (the checkpoints' counts), the printed
   and returned validation scores, the exact flash and per-layer launch
   counts and that the native IO library loaded; times the fit loop by
   events (also in a run with no validation or checkpoint inside it), the
   validations and one checkpoint save and restore; then
   trains 4 steps and resumes to 6 with ``--resume`` and ``--profile_dir``:
   the resumed state must equal the step-4 checkpoint bit for bit, and the
   profiled fit loop must show the three bf16 tensor-core flash kernels
   (no FMA one) and the per-layer kernels a layer step (4 and 9);
16. evaluates the step-6 checkpoint of phase 15's 6-step run through the
   port's evaluation entry points (``cli.evaluate_iq.main``, its per-layer
   kernels at b64 over the 128 validation questions): greedy with 3 prior
   draws per image and infomax consistency and validity maps written from
   the synthetic corpus (every output file, the metric ranges, exactly
   306 launches of each per-layer kernel per decode, and batch 0's tokens
   equal to a direct decode step call), ``cli.test_iq.main`` (the same
   files), beam search at b64 x 4 (306 launches), a sampled decode with
   ``--decode-top-k 1`` (the greedy questions), and a copy of the
   directory with ``use_stream_decode`` and int8 stack weights (51
   ``decode_stack_step`` launches per batch, tokens equal to a direct
   ``make_decode_step`` call); then ``cli.tune`` over the reference
   space, 2 samples, rungs 2 and 4, ``--parallel 2`` with both slots on
   card 0 (``use_pallas_attention``): each child reports the card, every
   rung's validation loss is finite and the analysis names the best trial.
   It prints the evaluation's questions/s by events on both paths, the
   restore and scoring times and each tune child's wall time;
17. the model variants and train-step options at the flagship's widths
   (seed-made weights, ``make_batch`` data, the launch counts of each
   path read around it and its time by CUDA events): (a) head dim 256
   (hidden 1024 over 4 heads): the compiler's registers and spills of the
   two head-dim-256 forwards, the three flash kernels against their plain
   versions at the four training shapes and B 8, T 512 causal, the one-
   and two-way ring at the training shape on seq 4 and at B 2, T 4096,
   each timed at those shapes with its bound and SDPA, one latent train
   step on the flash path against the einsum path within phase 7's
   limits, the ``<256>`` forwards' launches and device time in a latent
   step on the flash path and on the seq 4 ring path (by profiler), and a
   ``cli.tune`` trial child of that trial with ``use_pallas_attention``;
   (b) ViT-B/16 (BASELINE config
   4): the train CLI with ``--image_encoder vit_b16`` for 2 pretrain and
   2 latent steps on the flash kernels and one validation on the
   per-layer kernels (exact launch counts), then the directory served at
   b64 on the stream path with int8 stack weights and the fused head (51
   stack and head launches); (c) MoE (8 experts, top 2, capacity 1.25,
   every layer): the tokens per router call whose top-2 experts differ
   between the flash and einsum paths, and the flash path's step with
   every router call pinned to the einsum path's choice within phase 7's
   limits; a latent step on the flash path against the einsum path
   (limits of its own, set from readings: the router turns the paths'
   rounding into other experts for tokens near a tie), the balance and
   router-z losses finite and in the loss, greedy b64 on
   the plain path, and the per-layer and stream decode paths refused;
   (d) LSTM, then GRU: 2 pretrain and 1 latent step and greedy b64;
   (e) 3 latent steps with ``grad_dtype="bfloat16"`` and 3 with
   ``fused_adam=False`` on the flash path, and a ``fused_adam=False``
   checkpoint saved and restored bit for bit.  The ``kernels`` line's
   flash and ring rows carry the head-dim-256 readings (``dh256_*``);
18. data and tensor parallelism across processes, on its own numpy-made
   packed data: (a) the flagship through ``python -m
   torch.distributed.run --standalone --nproc_per_node 1 -m
   blt_vqg_tpu_torch.cli.train_iq`` (NCCL at world 1), 2 pretrain and 2
   latent steps on the flash kernels, once with ``--shard_opt_state`` and
   once with ``--fsdp``: exit 0, NCCL in the log, a finite final
   validation on the per-layer kernels, the fit loop's flash kernels by
   the profiler (84 each, no FMA one); the last run's step-4 checkpoint
   restored bit for bit, written with ``save_sharded`` and read back
   with ``restore_sharded`` bit-equal; (b) two processes sharing the card,
   each joined over an explicitly chosen gloo group (NCCL refuses two
   ranks on one GPU; gloo takes all-reduces of CUDA tensors): the
   flagship latent step at b64 on data 2 (32 rows a rank), then on model
   2 (4 heads a rank), each rank against the one-process step on the
   same weights, batch and generator within ``PAR_LIMITS`` (loss, grad
   norm, batch-norm statistics, updated parameters, first moments), 24
   launches of each flash kernel in each rank by counter and profiler,
   and the step time by events (two processes on one card: no measure of
   parallelism across cards).  ZeRO-1, FSDP and EP across ranks run only
   in the CPU tests (tests/test_torch_parallel.py, test_torch_multihost.py).
19. the ``seq`` ring and GPipe across two processes sharing the card
   over gloo (the point-to-point transport stages each hop through pinned
   host buffers there): (a) the flagship latent step at b64 with
   ``sequence_parallel`` on ``("data", "model", "seq")`` = (1, 1, 2),
   each process one rank of the ring (the decoder's T 20 rings, C 10 a
   rank), against the one-process ``LocalRing`` seq 2 step on the same
   weights, batch and generator within ``P2P_LIMITS``, with a control
   (another generator) that must fail; the ring and flash launches of
   each rank equal to what its plan predicts, by counter and profiler;
   hop bytes and the step time by events; then the four ring functions
   on the process ring against their plain versions on the same ring at
   the training shape and at B 2, T 4096 (phase 12's limits); (b) GPipe,
   ``pipe`` 2 with 2 microbatches, deterministic (dropouts 0): the
   latent step against the one-process step within ``PIPE_LIMITS`` (the
   control: another posterior noise), the flash launches of each rank as
   the schedule predicts (the encoders whole, the stage's 3 layers x 2
   attentions x 2 microbatches), the step time by events.  Neither
   measures anything across cards (one card, gloo through the host).

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

``--train-cli-only`` builds and runs phase 15 alone; ``--parallel-only``
phase 18 (``--parallel-seeds N`` takes 18b's readings over N seeds);
``--p2p-only`` phase 19 (``--p2p-seeds N``, its readings over N seeds);
``--eval-cli-only``
builds, runs the 6-step train CLI run and phase 16; ``--variants-only``
builds, checks phase 1's machine code and runs phase 17 alone.
``--flash-times-only``, ``--ring-times-only`` (the ring functions at the
training shape, phase 14), ``--dh256-times-only`` (phase 17a's times),
``--decode-times-only`` and ``--int8-times-only`` build, take only the
flash kernels' (phase 7), the ring functions', the head-dim-256 kernels',
the decode kernels' (the stack step, the fused head, also with a cold L2,
``self_attn_step`` and ``cross_ffn_step``) or ``int8_matmul``'s times at
both of its shapes (by events, host clock and profiler) and stop without a
result line; several of them run in one process: to compare two trees on
one card, run the same script from each tree in turns.

TF32 is off for matmuls and cuDNN throughout.  The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# the mangled-name mark of a kernel's head-dim-256 instantiation (DMAX 256),
# and the two forwards whose DMAX 256 instantiations split the output's
# columns between the two warps of a pair (they must not spill)
DMAX256 = "ILi256E"
FWD256 = ("flash_fwd_mma_kernel", "ring_fwd_mma_kernel")
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


def flash_shape_line(card, what, t, tag: str = "7") -> str:
    us = lambda key: f"{t[key] * 1e3:.1f} us"
    both = lambda key: f"{us(key)} (device {us(key + ':device')})"
    return (f"[{tag}] {card}: flash {what}, per call, by events (device time "
            f"by profiler): fwd kernel {both('flash_attention_fwd')}, plain "
            f"{us('plain_fwd')}, SDPA {both('sdpa_fwd')}; dK/dV kernel "
            f"{both('flash_attention_bwd_dkdv')} + dQ kernel "
            f"{both('flash_attention_bwd_dq')}, plain backward "
            f"{us('plain_bwd')}, SDPA backward {both('sdpa_bwd')}")


def flash_timings(dev, card, log, h: int = 8, d: int = 128, tag: str = "7",
                  multi: bool = True):
    """Phase 7 (kernels): per-call times at the four training shapes (B 64,
    ``h`` heads of ``d``), the totals of one latent train step's calls,
    and, with ``multi``, one call at the multi-tile shape (``long_*``).
    The two backward rows share their plain and library times: the plain
    backward and SDPA's backward each compute dq, dk and dv in one call."""
    totals = {n: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "library_ms": 0.0,
                  "library_device_ms": 0.0, "bytes": 0.0, "flops": 0.0}
              for n in FLASH_KERNELS}
    fwd = []    # the forward's and SDPA forward's device times per call
    for what, tq, tk, causal, calls in FLASH_SHAPES:
        t, bounds = flash_shape_times(dev, BATCH, h, d, tq, tk, causal,
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
        log(flash_shape_line(card, f"{what} (B {BATCH}, H {h}, Dh {d}, Tq "
                             f"{tq}, Tk {tk}{', causal' if causal else ''})",
                             t, tag))
    for name, tot in totals.items():
        tot["bound_by"] = bound(tot["bytes"], tot["flops"])[1]
        shared = ("" if name.endswith("fwd") else
                  " (shared by both backward rows: dq, dk and dv in one call)")
        log(f"[{tag}] {card}: {name} (H {h}, Dh {d}), the 24 calls of a "
            f"latent train step: "
            f"kernel {tot['ms'] * 1e3:.1f} us by events, "
            f"{tot['device_ms'] * 1e3:.1f} us device, bound "
            f"{tot['bound_ms'] * 1e3:.2f} us ({tot['bound_by']}); plain "
            f"{tot['plain_ms'] * 1e3:.1f} us and SDPA "
            f"{tot['library_ms'] * 1e3:.1f} us "
            f"({tot['library_device_ms'] * 1e3:.1f} us device){shared}")
    if not multi:
        return totals
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

def ring_inputs(dev, b, n, c, pad, seed, d=128, h=8):
    """bf16 q (scaled), k, v, dO [B, T, H h, Dh d] and a key-pad mask
    [B, T]: trailing pads of random lengths ("tail"), none ("none"), the
    last 10% of keys ("long"), or "dead": key 0 padded (the causal query 0
    sees no key) and every key of batch row 1."""
    t = n * c
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
    tensors, on a ring of n ranks held by this process
    (:func:`check_ring_shards`)."""
    ring = build_mesh((n,), ("seq",), q.device).ring()
    return check_ring_shards(ring, *(ring_shards(x, n) for x in (
        q, k, v, kv_pad, do)), causal, what)


def check_ring_shards(ring, qs, ks, vs, ps, dos, causal, what: str):
    """The four ring functions and their plain versions on the same shards
    of the ranks ``ring`` holds; raises unless every output is within the
    limits.  Returns ({function: max abs error of its own outputs: o; dq,
    dk and dv}, worst ulps, worst norm error, worst m/l error, and the
    backward's own worst ulps and norm error).  On a ring across
    processes the ranks' outputs are gathered first, so the errors are the
    whole ring's, as phase 12 reads them.  Every function runs before any
    limit is read, so the ranks make the same hops whatever one of them
    reads."""
    from blt_vqg_tpu_torch.parallel import collectives as col

    def whole(x):
        if ring.rank is None:
            return x
        return col.gather_dim(x.contiguous(), ring.group, 0, ring.n)

    errs, worst, failed = {}, [0.0] * 5, []
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
        got, (o, m, l), grads, ref = ([whole(x) for x in xs] for xs in (
            got, (o, m, l), grads, ref))
        ulps_b, norm_b = stack_errors(grads, ref)
        ulps, norm = (max(x, y) for x, y in zip(
            stack_errors([got[0]], [o]), (ulps_b, norm_b)))
        live = m > 0.5 * ra.NEG_INF
        ml = max(rel_max(got[1][live], m[live]), rel_max(got[2], l))
        if not torch.equal(got[1][~live], m[~live]):
            ml = math.inf
        if not (ulps <= RING_MAX_ULPS and norm <= RING_REL_NORM
                and ml <= RING_ML_REL):
            failed.append(f"ring {what} ({'two' if bidir else 'one'}-way): "
                          f"max err {ulps:.3g} bf16 ulps, rel norm err "
                          f"{norm:.3g}, m/l rel err {ml:.3g}")
        if bool((~live).any()) and not bool(got[0][~live].any()):
            failed.append(f"ring {what}: dead rows came out zero (the ring "
                          f"attends uniformly there)")
        abs_err = [float((g.float() - w.float()).abs().max())
                   for g, w in zip([got[0], *grads], [o, *ref])]
        errs[fwd], errs[bwd] = abs_err[0], max(abs_err[1:])
        for i, val in enumerate((ulps, norm, ml, ulps_b, norm_b)):
            worst[i] = max(worst[i], val)
    if failed:
        raise AssertionError("; ".join(failed))
    return (errs, *worst)


def ring_f32_errors(ring, qs, ks, vs, ps, dos, causal) -> dict:
    """The two-way kernels (bf16) and their plain version (bf16), each
    against the plain version in f32 on the same inputs: relative norm
    errors of o, dq, dk and dv (which of the two rounds further from the
    f32 result)."""
    f32 = [x.float() if x.is_floating_point() else x
           for x in (qs, ks, vs, ps, dos)]
    want_o, wm, wl = ra.ring_attention_fwd_bidir_shard_ref(
        *f32[:4], ring=ring, causal=causal)
    want = [want_o, *ra.ring_attention_bwd_bidir_shard_ref(
        *f32[:4], want_o, wm, wl, f32[4], ring=ring, causal=causal)]
    out = {}
    for tag, fwd, bwd in (
            ("kernel", ra.ring_attention_fwd_bidir_shard,
             ra.ring_attention_bwd_bidir_shard),
            ("plain", ra.ring_attention_fwd_bidir_shard_ref,
             ra.ring_attention_bwd_bidir_shard_ref)):
        o, m, l = fwd(qs, ks, vs, ps, ring=ring, causal=causal,
                      **({"return_lse": True} if tag == "kernel" else {}))
        got = [o, *bwd(qs, ks, vs, ps, o, m, l, dos, ring=ring,
                       causal=causal)]
        out[tag] = {name: float((g.float() - w).norm() / w.norm())
                    for name, g, w in zip(("o", "dq", "dk", "dv"), got,
                                          want)}
    return out


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


def ring_case_times(dev, card, log, label, case, h: int = 8, d: int = 128,
                    tag: str = "14") -> dict:
    """Each ring function at one shape of RING_CASES (``h`` heads of
    ``d``), per call: by events, device time by profiler (ring kernels and
    the rest), the plain version, the bound and SDPA.  Returns {function:
    {ms, device_ms, launches_per_call, plain_ms, bound_ms, bound_by,
    library_ms}}."""
    what, b, n, c, causal, pad = case
    q, k, v, kv_pad, do = ring_inputs(dev, b, n, c, pad, SEED + 1, d, h)
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
    bounds = ring_bounds(b, n, c, kv_pad, causal, h, d)
    times = {}
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
        # (a profile that recorded no ring kernel is taken again, up to
        # twice more: every call launches them)
        for _ in range(3):
            groups = profile_groups(lambda: fn(*args, ring=ring,
                                               causal=causal), 3,
                                    RING_KERNEL_NAMES)
            kn, kdev = (sum(groups.get(k, (0, 0.0))[i]
                            for k in RING_KERNEL_NAMES) for i in (0, 1))
            if kn:
                break
        on, odev = groups.get("other", (0, 0.0))
        nbytes, flops = bounds[name]
        b_ms, b_by = bound(nbytes, flops)
        lib = sdpa_fwd if fwd else sdpa_bwd
        log(f"[{tag}] {card}: {name}, {label} shape ({what}; B {b}, H {h}, "
            f"Dh {d}), per call: kernel {k_ms * 1e3:.1f} us by events, "
            f"device time {kdev * 1e3:.1f} us in {kn:.0f} ring kernel "
            f"launches (+ {odev * 1e3:.1f} us in {on:.0f} other device "
            f"operations: copies), plain {p_ms * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.2f} us ({b_by}), SDPA "
            f"{'forward' if fwd else 'backward'} {lib * 1e3:.1f} us;"
            f" hops move {hops} bytes; by kernel: " + ", ".join(
                f"{k} {groups[k][1] * 1e3:.1f} us in {groups[k][0]:.0f}"
                for k in RING_KERNEL_NAMES if k in groups))
        times[name] = {"ms": k_ms, "device_ms": kdev, "launches_per_call": kn,
                       "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib}
    return times


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
    for label, case in (("training", RING_TRAIN_CASE),
                        ("long", RING_LONG_CASE)):
        for name, t in ring_case_times(dev, card, log, label, case).items():
            if label == "training":
                rows[name] = {"ms": calls * t["ms"],
                              "plain_ms": calls * t["plain_ms"],
                              "bound_ms": calls * t["bound_ms"],
                              "bound_by": t["bound_by"],
                              "library_ms": calls * t["library_ms"],
                              "device_ms": calls * t["device_ms"],
                              "launches_per_call": t["launches_per_call"]}
            else:           # one call at the long shape
                rows[name].update({"long_" + k: t[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})
    return rows


def ptxas_entries(report: str):
    """(kernel, its "Used N registers" match, its spill stores match) for
    each entry function of a ``ptxas -v`` report (None where absent)."""
    for entry in report.split("Compiling entry function")[1:]:
        yield (entry.split("'")[1],
               re.search(r"Used (\d+) registers[^\n]*", entry),
               re.search(r"(\d+) bytes spill stores", entry))


def mma_code(lib_path: str, report: str) -> None:
    """Phase 1: the compiler's registers and spills of the ring and flash
    kernels, of the decode kernels' split-K product and fused residual
    + LayerNorm, and of the cluster product's kernels and the kernels
    beside them (with their dynamic shared memory) and of
    int8_wgmma_kernel; raises unless the machine code of each bf16
    tensor-core kernel (RING_MMA, FLASH_MMA, CLUSTER_MMA, INT8_KERNEL) has
    tensor-core products (HMMA or HGMMA; HGMMA for INT8_KERNEL), and unless
    ptxas reports no spills for the flash (head dims up to 128: the
    ``DMAX`` 128 instantiations the training shapes run), cluster and int8
    kernels and the two head-dim-256 forwards (the ring forward's DMAX 128
    registers are capped for 3 blocks per SM, and it spills a few bytes by
    design; the head-dim-256 backward kernels' spills are printed, not
    refused)."""
    kernels = RING_MMA + FLASH_MMA + CLUSTER_MMA + (INT8_KERNEL,)
    watched = ("ring_", "flash_", "gemm_partial_kernel", "residual_ln_kernel",
               *CLUSTER_MMA, *CLUSTER_OTHER, INT8_KERNEL)
    for name, used, spill in ptxas_entries(report):
        if any(w in name for w in watched):
            log(f"    ptxas {name}: {used.group(0) if used else '?'}; "
                f"spill stores {spill.group(1) if spill else '?'} bytes")
            kept = (DMAX256 in name and any(k in name for k in FWD256)) or (
                DMAX256 not in name and any(
                    k in name for k in FLASH_MMA + CLUSTER_MMA
                    + (INT8_KERNEL,)))
            if kept and not (spill and spill.group(1) == "0"):
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
# ---------------------------------------------------------------------------
# the train CLI (phase 15)

def write_packed(directory: str, questions: int, images: int, vocab: int,
                 seed: int, q_len: int = 20, a_len: int = 4,
                 categories: int = 8, size: int = 224) -> str:
    """A synthetic packed dataset (data/packed.py's format: images.npy
    uint8 and tokens.npz) made with numpy from ``seed``: questions and
    answers of random words between <start> and <end>, as
    data/synthetic.py makes them, no h5py."""
    rng = np.random.RandomState(seed)

    def rand_seq(max_len, lo_len, hi_len):
        seqs = np.zeros((questions, max_len), np.int32)
        for i in range(questions):
            n = min(rng.randint(lo_len, hi_len + 1), max_len - 2)
            seqs[i, 0] = START
            seqs[i, 1:1 + n] = rng.randint(6, vocab, size=n)
            seqs[i, 1 + n] = 3          # <end>
        return seqs

    os.makedirs(directory)
    np.save(os.path.join(directory, "images.npy"),
            rng.randint(0, 256, (images, size, size, 3), dtype=np.uint8))
    np.savez(os.path.join(directory, "tokens.npz"),
             questions=rand_seq(q_len, 3, q_len - 2),
             answers=rand_seq(a_len, 1, a_len - 2),
             answer_types=rng.randint(0, categories, questions
                                      ).astype(np.int32),
             image_indices=rng.randint(0, images, questions).astype(np.int64),
             image_ids=np.arange(questions, dtype=np.int64) + 1000)
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"source": "chip_smoke.py", "uint8_images": True}, f)
    return directory


def train_cli_argv(data: dict, out: str, steps: int, *extra) -> list:
    """The flagship (serve.flagship_config) on the train CLI, with the
    flash kernels in training and the per-layer kernels in validation."""
    c = serve.flagship_config()
    return [f"--emb_dim={c.emb_dim}", f"--hidden_dim={c.hidden_dim}",
            f"--latent_dim={c.latent_dim}", f"--pwffn_dim={c.pwffn_dim}",
            f"--num_layers={c.num_layers}", f"--num_heads={c.num_heads}",
            f"--input_mode={c.input_mode}", f"--dtype={c.dtype}",
            f"--image_size={c.image_size}", f"--batch_size={BATCH}",
            "--use_pallas_attention", "--attention_dropout=0.0",
            "--use_pallas_decode", "--num_pretraining_steps=2",
            f"--total_training_steps={steps}", "--steps_per_dispatch=2",
            "--val_check_interval=3", "--limit_val_batches=1",
            "--checkpoint_every=2", "--latent_diagnostics",
            f"--seed={SEED}", f"--vocab={data['vocab']}",
            f"--dataset={data['train']}", f"--val_dataset={data['val']}",
            f"--output_dir={out}", *extra]


def flash_launches():
    return {fn: getattr(fa, fn).launches for fn in FLASH_KERNELS}


def zero_flash_launches():
    for fn in FLASH_KERNELS:
        getattr(fa, fn).launches = 0


def run_train_cli(argv) -> tuple:
    """``cli.train_iq.main(argv)`` with its standard output captured:
    (its result, the text it printed)."""
    from blt_vqg_tpu_torch.cli import train_iq
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = train_iq.main(argv)
    return result, buf.getvalue()


def validation_blocks(text: str) -> dict:
    """{step: {name: value}} of each printed validation report (the metric
    lines after its header; the samples come before it)."""
    blocks, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"^##### validation @ step (\d+) #####$", line)
        if m:
            cur = blocks.setdefault(int(m.group(1)), [])
            cur.append({})
            continue
        parts = line.split(" \t ")
        if cur is not None and len(parts) == 2:
            try:
                cur[-1][parts[0]] = float(parts[1])
            except ValueError:
                pass
        elif cur is not None:
            cur = None
    return blocks


def opt_count(out: str, step: int) -> int:
    with np.load(os.path.join(out, "checkpoints", f"step_{step}",
                              "state.npz")) as z:
        return int(z["opt_state/.count"])


def same_entries(a: dict, b: dict, what: str) -> None:
    """Raises unless two checkpoint entry dicts hold the same keys and the
    same bytes."""
    if set(a) != set(b):
        raise AssertionError(f"{what}: keys differ: "
                             f"{sorted(set(a) ^ set(b))[:5]}")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                np.ascontiguousarray(x).view(np.uint8).ravel(),
                np.ascontiguousarray(y).view(np.uint8).ravel()):
            raise AssertionError(f"{what}: {k} differs")


# flash launches of one latent validation with the latent report: the eval
# step (24) and the decodes' encoders, by flash forward alone: the report's
# decode and the prior-sample and prior-mean decodes 6 each (context
# encoder), the statistics and the posterior-mean decode 12 each (context
# and posterior encoders)
VAL_FLASH_FWD = 24 + 6 + 12 + 6 + 6 + 12
# greedy decodes of one validation: the report's and three z sources'
VAL_DECODES = 4
# per-layer kernels of one layer step: self_attn_step's 4 and
# cross_ffn_step's 9
LAYER_STEP_KERNELS = {k: SELF_KERNELS.get(k, 0) + CROSS_KERNELS.get(k, 0)
                      for k in {**SELF_KERNELS, **CROSS_KERNELS}}
PROFILE_MIN_SHARE = 0.9   # the profiler may drop a few of many records


def trace_kernels(path: str) -> dict:
    """{kernel name: records} of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def cli_data(root: str, log, tag: str = "15") -> dict:
    """The train CLI's synthetic packed datasets and vocab under ``root``;
    checks that the native IO library loaded."""
    from blt_vqg_tpu_torch.data import native
    from blt_vqg_tpu_torch.text.vocabulary import Vocabulary

    t0 = time.perf_counter()
    vocab = Vocabulary()
    for i in range(serve.FLAGSHIP_VOCAB - len(vocab)):
        vocab.add_word(f"w{i}")
    data = {"vocab": os.path.join(root, "vocab.json")}
    vocab.save(data["vocab"])
    data["train"] = write_packed(os.path.join(root, "train"), 512, 128,
                                 len(vocab), SEED + 500)
    data["val"] = write_packed(os.path.join(root, "val"), 128, 32,
                               len(vocab), SEED + 501)
    log(f"[{tag}] synthetic packed data in {time.perf_counter() - t0:.1f} "
        f"s: 512 train questions over 128 images 224x224x3 uint8, 128 "
        f"validation questions over 32 images, vocab {len(vocab)}")
    if not native.available():
        raise AssertionError("the native IO library did not load: the "
                             "packed dataset would gather on the numpy "
                             "fallback")
    log(f"[{tag}] native IO library loaded: {native.library_path()}")
    return data


def train_cli_phase(dev, card, log, then=None):
    """Phase 15: the flagship trained through the port's train CLI
    (``cli.train_iq.main``) on a synthetic packed dataset: 2 pretrain
    steps, the Adam restart, 4 latent steps in dispatches of 2, 1, 1 and 2
    steps, validations at steps 3 and 6 and a final one, checkpoints every
    2 steps (after the same 6 steps with no validation or checkpoint inside
    fit, timed); then 4 steps and a resumed run to 6 under the profiler.
    ``then(data, model_dir)`` runs last, on the data and the model
    directory of the 6-step run (phase 16)."""
    import shutil
    import tempfile
    from blt_vqg_tpu_torch.core.checkpoint import (CheckpointManager,
                                                   flatten_state)
    from blt_vqg_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="train_cli_")
    try:
        data = cli_data(root, log)

        # ---- 6 steps with no validation or checkpoint inside fit: the fit
        # loop's own cost against the bare step (and the first steps' set-up,
        # so that run A starts warm)
        out = os.path.join(root, "bare")
        r, _ = run_train_cli(train_cli_argv(
            data, out, 6, "--val_check_interval=1000",
            "--checkpoint_every=1000", "--no_checkpoint_at_end"))
        tm = r["trainer"].timings
        fit_ms, n = tm["fit_ms"][0], tm["fit_steps"][0]
        log(f"[15] {card}: fit loop without validation or checkpoints: {n} "
            f"steps of b{BATCH} in {fit_ms:.1f} ms by events = "
            f"{n * BATCH / fit_ms * 1e3:.1f} samples/s; dispatches of 2 steps "
            f"{[round(x, 1) for x in tm['dispatch_ms']]} ms (the first with "
            f"the process's first steps)")
        del r
        shutil.rmtree(out, ignore_errors=True)

        # ---- run A: 6 steps
        out = os.path.join(root, "run")
        zero_flash_launches()
        zero_layer_launches()
        t0 = time.perf_counter()
        r, text = run_train_cli(train_cli_argv(data, out, 6))
        wall = time.perf_counter() - t0
        trainer, state, final = r["trainer"], r["state"], r["val"]
        flash, layer = flash_launches(), layer_launches()
        if (state.step, state.kliter) != (6, 4):
            raise AssertionError(f"step {state.step}, kliter {state.kliter}")
        hist = [(s, {k: float(v) for k, v in m.items()})
                for s, m in trainer.history]
        if [s for s, _ in hist] != [2, 3, 4, 6]:
            raise AssertionError(f"dispatches ended at {[s for s, _ in hist]}")
        for s, m in hist:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"step {s}: non-finite metrics {m}")
            if (m["kld"] > 0.0) != (s > 2):
                raise AssertionError(f"step {s}: kld {m['kld']}")
            log(f"[15] after step {s}: loss {m['loss']:.6g}, rec "
                f"{m['rec']:.5g}, kld {m['kld']:.5g}, aux {m['aux']:.5g}, "
                f"grad_norm {m['grad_norm']:.5g}")
        counts = {s: opt_count(out, s) for s in (2, 4, 6)}
        if counts != {2: 2, 4: 2, 6: 4}:
            raise AssertionError(f"Adam counts in the checkpoints {counts}, "
                                 f"want 2, 2 (reset at step 2) and 4")
        log(f"[15] Adam count in the checkpoints of steps 2, 4, 6: "
            f"{counts} (reset at the phase boundary)")
        blocks = validation_blocks(text)
        want_keys = {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                     "ROUGE_L", "CIDEr", "z_active_dims", "z_kl_top_dim",
                     "z_prior_logvar", "z_post_logvar", "z_prior_mean_var",
                     "z_mean_gap", "bleu4_prior_sample", "bleu4_prior_mean",
                     "bleu4_posterior_mean", "bleu4_prior_gap", "loss"}
        if sorted((s, len(b)) for s, b in blocks.items()) != [(3, 1), (6, 2)]:
            raise AssertionError(f"validation reports printed: "
                                 f"{ {s: len(b) for s, b in blocks.items()} }")
        for s, bs in sorted(blocks.items()):
            for b in bs:
                if not want_keys <= set(b) or not all(
                        math.isfinite(v) for v in b.values()):
                    raise AssertionError(f"validation @ {s}: {b}")
                log(f"[15] validation @ step {s}: " + ", ".join(
                    f"{k} {b[k]:.4g}" for k in (
                        "loss", "kld", "Bleu_1", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr", "z_active_dims",
                        "bleu4_prior_sample", "bleu4_posterior_mean")))
        returned = {"nlg_Bleu_4", "nlg_METEOR", "nlg_ROUGE_L", "nlg_CIDEr",
                    "z_active_dims", "bleu4_prior_gap"}
        if not returned <= set(final) or "Generated:" not in text:
            raise AssertionError(f"final validation returned {sorted(final)}")
        vals = 3
        want_flash = {"flash_attention_fwd": 2 * 18 + 4 * 24
                      + vals * VAL_FLASH_FWD,
                      "flash_attention_bwd_dkdv": 2 * 18 + 4 * 24,
                      "flash_attention_bwd_dq": 2 * 18 + 4 * 24}
        steps = serve.flagship_config().max_decode_length + 1
        layers = serve.flagship_config().num_layers
        want_layer = vals * VAL_DECODES * steps * layers
        if flash != want_flash or layer != {k: want_layer
                                            for k in LAYER_KERNELS}:
            raise AssertionError(f"launches {flash} {layer}, want "
                                 f"{want_flash} and {want_layer} each")
        log(f"[15] launches over the run: {flash}, {layer}")
        tm = trainer.timings
        fit_ms, n = tm["fit_ms"][0], tm["fit_steps"][0]
        step_ms = sum(tm["dispatch_ms"])
        log(f"[15] {card}: fit loop {n} steps of b{BATCH} in {fit_ms:.1f} ms "
            f"by events = {n * BATCH / fit_ms * 1e3:.1f} samples/s (with 2 "
            f"validations and 3 checkpoint copies); the train dispatches "
            f"{step_ms:.1f} ms = {n * BATCH / step_ms * 1e3:.1f} samples/s "
            f"(dispatches {[round(x, 1) for x in tm['dispatch_ms']]} ms); "
            f"validations {[round(x, 1) for x in tm['validate_ms']]} ms "
            f"(host clock); async checkpoint host copies "
            f"{[round(x, 1) for x in tm['save_ms']]} ms; the CLI run "
            f"{wall:.1f} s (host clock)")
        cfg = trainer.cfg
        mgr = CheckpointManager(os.path.join(root, "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(state, cfg, block=True)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "state.npz"))
        t0 = time.perf_counter()
        mgr.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        log(f"[15] {card}: one checkpoint of the step-6 state, "
            f"{nbytes / 1e9:.3f} GB: save {save_s:.2f} s (blocking), "
            f"restore {restore_s:.2f} s (host clock)")
        del r, trainer, state, final, mgr
        model_dir = out     # phase 16 evaluates its step-6 checkpoint
        shutil.rmtree(os.path.join(root, "timed"), ignore_errors=True)

        # ---- runs B and C: 4 steps, then a resumed run to 6
        out = os.path.join(root, "resume")
        rb, _ = run_train_cli(train_cli_argv(data, out, 4))
        saved = flatten_state(rb["state"])
        if rb["state"].step != 4:
            raise AssertionError(f"run to 4 ended at {rb['state'].step}")
        del rb
        started = {}
        init_state = Trainer.init_state

        def spy(self, *a, **k):
            st = init_state(self, *a, **k)
            started.update(flatten_state(st))
            return st

        trace_dir = os.path.join(root, "trace")
        zero_flash_launches()
        zero_layer_launches()
        Trainer.init_state = spy
        try:
            rc, _ = run_train_cli(train_cli_argv(data, out, 6, "--resume",
                                                 f"--profile_dir={trace_dir}"))
        finally:
            Trainer.init_state = init_state
        same_entries(started, saved, "the resumed state against run B's")
        with np.load(os.path.join(out, "checkpoints", "step_4",
                                  "state.npz")) as z:
            same_entries(started, {k: z[k] for k in z.files},
                         "the resumed state against the step-4 file")
        log(f"[15] resume: the run to 6 started at step "
            f"{int(started['__step__'])}, kliter "
            f"{int(started['__kliter__'])}, Adam count "
            f"{int(started['opt_state/.count'])}, with its {len(started)} "
            f"checkpoint entries (parameters, batch statistics, moments) "
            f"equal bit for bit to the step-4 checkpoint and to run B's "
            f"final state")
        del started, saved
        state, hist = rc["state"], list(rc["trainer"].history)
        if (state.step, state.kliter) != (6, 4) or [s for s, _ in hist] != [6]:
            raise AssertionError(f"resumed run: step {state.step}, "
                                 f"dispatches {[s for s, _ in hist]}")
        m = {k: float(v) for k, v in hist[0][1].items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"resumed steps 4-5: {m}")
        if CheckpointManager(os.path.join(out, "checkpoints")
                             ).latest_step() != 6:
            raise AssertionError("the resumed run saved no step 6")
        log(f"[15] resumed steps 4-5 (one dispatch of 2): loss "
            f"{m['loss']:.6g}, kld {m['kld']:.5g}; step 6 saved")
        flash, layer = flash_launches(), layer_launches()
        want_flash = {"flash_attention_fwd": 2 * 24 + 2 * VAL_FLASH_FWD,
                      "flash_attention_bwd_dkdv": 2 * 24,
                      "flash_attention_bwd_dq": 2 * 24}
        if flash != want_flash or layer != {
                k: 2 * VAL_DECODES * steps * layers for k in LAYER_KERNELS}:
            raise AssertionError(f"resumed run launches {flash} {layer}")
        del rc, state

        # the profiled fit loop: 2 latent train steps and one validation
        kernels = trace_kernels(os.path.join(trace_dir, "trace.json"))
        fams = {}
        for name, n in kernels.items():
            fam = kernel_family(name, FLASH_STEP_KERNELS
                                + tuple(LAYER_STEP_KERNELS))
            fams[fam] = fams.get(fam, 0) + n
        want = {"flash_fwd_mma_kernel": 2 * 24 + VAL_FLASH_FWD,
                "flash_bwd_dkdv_mma_kernel": 2 * 24,
                "flash_bwd_dq_mma_kernel": 2 * 24}
        layer_steps = VAL_DECODES * steps * layers
        want.update({k: v * layer_steps
                     for k, v in LAYER_STEP_KERNELS.items()})
        bad = {k: (fams.get(k, 0), w) for k, w in want.items()
               if not PROFILE_MIN_SHARE * w <= fams.get(k, 0) <= w}
        bad.update({k: fams[k] for k in FLASH_FMA if fams.get(k)})
        log(f"[15] profiled fit loop of the resumed run ({sum(fams.values())}"
            f" kernel records): " + ", ".join(
                f"{k} {fams.get(k, 0)}/{w}" for k, w in want.items())
            + f"; FMA flash kernels "
            f"{ {k: fams.get(k, 0) for k in FLASH_FMA} }")
        if bad:
            raise AssertionError(f"profiled kernels (records, want): {bad}")
        log(f"[15] the train steps ran the three bf16 tensor-core flash "
            f"kernels and no FMA one; the validation decode ran "
            f"self_attn_step's {sum(SELF_KERNELS.values())} and "
            f"cross_ffn_step's {sum(CROSS_KERNELS.values())} kernels a "
            f"layer step ({layer_steps} layer steps)")
        if then is not None:
            then(data, model_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the evaluation CLIs (phase 16)

EVAL_Z = 3            # prior draws per image of the greedy evaluation
EVAL_QUESTIONS = 128  # the validation split of cli_data


class EvalSpy:
    """Around a run of the evaluation CLI: the trainer it builds, the tokens
    and CUDA-event marks of each call of the trainer's decode steps (greedy
    and the prior draws), the restore time and the NLG and infomax scoring
    times (host clock)."""

    def __init__(self):
        self.trainers, self.calls = [], []
        self.restore_s, self.nlg_s, self.infomax_s = [], [], []

    def _timed_step(self, fn):
        def step(images, context, generator=None, sample_generator=None):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(images, context, generator, sample_generator)
            b.record()
            self.calls.append((out["tokens"].clone(), a, b))
            return out
        return step

    def decode_ms(self, calls) -> float:
        return sum(self.call_ms(calls))

    def call_ms(self, calls) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for _, a, b in calls]

    @contextlib.contextmanager
    def on(self):
        from blt_vqg_tpu_torch.core.checkpoint import CheckpointManager
        from blt_vqg_tpu_torch.train import infomax
        from blt_vqg_tpu_torch.train.nlg_metrics import NLGEval
        from blt_vqg_tpu_torch.train.trainer import Trainer

        originals = (Trainer.__init__, CheckpointManager.restore,
                     NLGEval.compute_metrics, infomax.diversity_metrics)
        init, restore, nlg, div = originals

        def host_timed(fn, into, sync=False):
            def timed(*a, **k):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return timed

        def trainer_init(tr, *a, **k):
            init(tr, *a, **k)
            self.trainers.append(tr)
            tr._decode_steps = {m: self._timed_step(f)
                                for m, f in tr._decode_steps.items()}

        Trainer.__init__ = trainer_init
        CheckpointManager.restore = host_timed(restore, self.restore_s, True)
        NLGEval.compute_metrics = host_timed(nlg, self.nlg_s)
        infomax.diversity_metrics = host_timed(div, self.infomax_s)
        try:
            yield self
        finally:
            (Trainer.__init__, CheckpointManager.restore,
             NLGEval.compute_metrics, infomax.diversity_metrics) = originals


def stack_launches() -> int:
    return decode_stream.decode_stack_step.launches


def run_eval_cli(main, model_dir: str, out: str, *flags) -> tuple:
    """``main`` (``cli.evaluate_iq.main`` or ``cli.test_iq.main``) on
    ``model_dir`` with its launch counts set to 0 before it:
    (the files it wrote, the spy, the launches, its wall seconds)."""
    spy = EvalSpy()
    zero_layer_launches()
    decode_stream.decode_stack_step.launches = 0
    decode_head.head_argmax.launches = 0
    t0 = time.perf_counter()
    with spy.on():
        rc = main(["--model-dir", model_dir, "--results-dir", out, *flags])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"evaluation {flags} returned {rc}")
    launches = {**layer_launches(), "decode_stack_step": stack_launches(),
                "head_argmax": decode_head.head_argmax.launches}
    files = {}
    for name in ("results", "preds", "gts", "z_samples"):
        path = os.path.join(out, name + ".json")
        if os.path.exists(path):
            with open(path) as f:
                files[name] = json.load(f)
    return files, spy, launches, wall


def first_eval_batch(trainer, cfg, dataset_dir: str):
    """The eval-augmented images and the context of the evaluation's first
    batch (the same loader as the CLI's)."""
    from blt_vqg_tpu_torch.data.loader import make_loader
    from blt_vqg_tpu_torch.data.packed import PackedDataset

    loader = make_loader(PackedDataset(dataset_dir, trainer.vocab),
                         cfg.batch_size, cfg.input_mode, shuffle=False,
                         epochs=1, device=trainer.device)
    try:
        batch = next(loader)
    finally:
        loader.close()
    return trainer.augment_eval(batch["images"]), batch["context"]


def tune_cli_run(argv, log_path: str) -> int:
    """``cli.tune.main(argv)`` with this process's and its children's
    standard output and error sent to ``log_path``."""
    from blt_vqg_tpu_torch.cli import tune as tune_cli

    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    with open(log_path, "w") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        try:
            return tune_cli.main(argv)
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])


def eval_cli_phase(dev, card, log, data: dict, model_dir: str):
    """Phase 16: the step-6 latent checkpoint of the train CLI's run
    evaluated through the port's evaluation entry points, on the
    per-layer kernels (``use_pallas_decode`` in its args.json): greedy with
    3 prior draws and the infomax maps, beam search, sampled top-1, the
    stream path on a copy of the directory, ``test_iq``; then
    ``cli.tune`` with two trial children on the card."""
    from blt_vqg_tpu_torch.cli import evaluate_iq, test_iq
    from blt_vqg_tpu_torch.core.config import Config
    from blt_vqg_tpu_torch.data.packed import PackedDataset
    from blt_vqg_tpu_torch.text.vocabulary import load_vocab
    from blt_vqg_tpu_torch.train.step import make_decode_step
    from blt_vqg_tpu_torch.train.trainer import filter_special_tokens

    t_phase = time.perf_counter()
    root = os.path.dirname(model_dir)
    cfg = Config.load(os.path.join(model_dir, "args.json"))
    if not cfg.use_pallas_decode or cfg.use_stream_decode:
        raise AssertionError("phase 16 evaluates a per-layer decode model")
    steps, layers = cfg.max_decode_length + 1, cfg.num_layers
    nbatch = EVAL_QUESTIONS // cfg.batch_size
    per_decode = steps * layers    # launches of each per-layer kernel

    # the infomax maps from the synthetic corpus: each category word must
    # appear in its questions; each validation question is the one valid
    # question of its own combo
    vocab = load_vocab(cfg.vocab)
    cats = sorted(set(int(c) for c in PackedDataset(
        data["val"], vocab).answer_types_raw))
    cmap = {vocab.idx2word[6 + c]: [vocab.idx2word[6 + c]] for c in cats}
    questions = np.load(os.path.join(data["val"], "tokens.npz"))["questions"]
    valid = {str(i): [" ".join(filter_special_tokens(
        [vocab.idx2word[int(t)] for t in row]))]
        for i, row in enumerate(questions)}
    maps = {}
    for name, obj in (("consistency_map", cmap), ("valid_map", valid)):
        maps[name] = os.path.join(root, name + ".json")
        with open(maps[name], "w") as f:
            json.dump(obj, f)
    greedy_flags = ["--num-z-samples", str(EVAL_Z), "--consistency-map",
                    maps["consistency_map"], "--valid-map", maps["valid_map"]]

    # ---- greedy with 3 prior draws per image
    files, spy, launches, wall = run_eval_cli(
        evaluate_iq.main, model_dir, os.path.join(root, "eval_greedy"),
        *greedy_flags)
    if set(files) != {"results", "preds", "gts", "z_samples"}:
        raise AssertionError(f"greedy evaluation wrote {sorted(files)}")
    zs = files["z_samples"]
    if (len(files["preds"]) != EVAL_QUESTIONS
            or len(files["gts"]) != EVAL_QUESTIONS
            or len(zs["samples"]) != EVAL_Z
            or any(len(q) != EVAL_QUESTIONS for q in zs["samples"])
            or len(zs["contexts"]) != EVAL_QUESTIONS):
        raise AssertionError("greedy evaluation: output sizes")
    res = files["results"]
    infomax_keys = {"distinct_rate", "distinct_1", "distinct_2", "self_bleu",
                    "consistency", "valid_rate", "distinct_valid"}
    nlg_keys = {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                "CIDEr"}
    if set(res) != nlg_keys | {f"infomax_{k}" for k in infomax_keys}:
        raise AssertionError(f"results.json keys {sorted(res)}")
    for k, v in res.items():
        top = EVAL_Z if k == "infomax_distinct_valid" else (
            10.0 if k == "CIDEr" else 1.0)
        if not (math.isfinite(v) and 0.0 <= v <= top):
            raise AssertionError(f"results.json {k} = {v}")
    want = per_decode * (1 + EVAL_Z) * nbatch
    if launches != {**{k: want for k in LAYER_KERNELS},
                    "decode_stack_step": 0, "head_argmax": 0}:
        raise AssertionError(f"greedy evaluation launches {launches}, want "
                             f"{want} of each per-layer kernel")
    trainer = spy.trainers[0]
    greedy = spy.calls[0][0]    # batch 0's greedy decode
    images, context = first_eval_batch(trainer, cfg, data["val"])
    direct = make_decode_step(cfg, trainer.model, True)(
        images, context, trainer._key(0))["tokens"]
    if not torch.equal(direct, greedy):
        raise AssertionError("the greedy evaluation's tokens differ from a "
                             "direct decode step call")
    calls = len(spy.calls)
    greedy_ms = spy.decode_ms(spy.calls[::1 + EVAL_Z])
    all_ms = spy.decode_ms(spy.calls)
    log(f"[16] greedy evaluation of step 6 ({EVAL_QUESTIONS} questions, "
        f"{nbatch} batches of {cfg.batch_size}, {EVAL_Z} prior draws each): "
        f"{', '.join(f'{k} {v:.4g}' for k, v in res.items())}")
    log(f"[16] launches {launches} = {per_decode} x (1 + {EVAL_Z}) x "
        f"{nbatch}; batch 0's greedy tokens equal a direct make_decode_step "
        f"call on the same batch and generator")
    log(f"[16] {card}: per-layer evaluation decode {EVAL_QUESTIONS / greedy_ms * 1e3:.1f}"
        f" questions/s by events (greedy calls {greedy_ms:.1f} ms), "
        f"{calls * cfg.batch_size / all_ms * 1e3:.1f} over all {calls} "
        f"decode calls with the draws ({all_ms:.1f} ms; calls "
        f"{[round(x, 1) for x in spy.call_ms(spy.calls)]} ms, the first "
        f"building the per-layer weights); restore "
        f"{spy.restore_s[0]:.2f} s, NLG scoring {spy.nlg_s[0]:.2f} s, "
        f"infomax scoring {spy.infomax_s[0]:.3f} s (host clock); the CLI "
        f"run {wall:.1f} s")
    del trainer, spy, images, context

    # ---- test_iq: the same machinery, the same results
    t_files, _, t_launches, t_wall = run_eval_cli(
        test_iq.main, model_dir, os.path.join(root, "test_iq"),
        *greedy_flags)
    if t_files != files or t_launches != launches:
        raise AssertionError("test_iq wrote other results than evaluate_iq")
    log(f"[16] test_iq: results, preds, gts and z_samples equal to "
        f"evaluate_iq's, the same launches ({t_wall:.1f} s)")

    # ---- beam search, 4 beams, one batch
    b_files, _, b_launches, b_wall = run_eval_cli(
        evaluate_iq.main, model_dir, os.path.join(root, "eval_beam"),
        "--beam-size", str(BEAM), "--max-batches", "1")
    if (b_launches != {**{k: per_decode for k in LAYER_KERNELS},
                       "decode_stack_step": 0, "head_argmax": 0}
            or len(b_files["preds"]) != cfg.batch_size
            or "z_samples" in b_files
            or not all(math.isfinite(v) for v in b_files["results"].values())):
        raise AssertionError(f"beam evaluation: launches {b_launches}, "
                             f"{len(b_files['preds'])} questions")
    log(f"[16] beam evaluation (b{cfg.batch_size} x {BEAM}, one batch): "
        f"launches {b_launches}; Bleu_4 {b_files['results']['Bleu_4']:.4g} "
        f"({b_wall:.1f} s)")

    # ---- sampled decode with top-k 1: the greedy questions
    s_files, _, s_launches, s_wall = run_eval_cli(
        evaluate_iq.main, model_dir, os.path.join(root, "eval_top1"),
        "--decode-sampling", "--decode-top-k", "1", "--num-z-samples", "1",
        "--max-batches", "1")
    if s_files["preds"] != files["preds"][:cfg.batch_size] or (
            s_launches[LAYER_KERNELS[0]] != per_decode):
        raise AssertionError("sampled top-1 evaluation differs from greedy")
    log(f"[16] sampled evaluation with --decode-top-k 1: its "
        f"{len(s_files['preds'])} questions equal the greedy ones "
        f"({s_wall:.1f} s)")

    # ---- the stream path: a copy of the directory with int8 stack weights
    stream_dir = os.path.join(root, "run_stream")
    os.makedirs(stream_dir)
    os.symlink(os.path.join(model_dir, "checkpoints"),
               os.path.join(stream_dir, "checkpoints"))
    cfg.replace(use_stream_decode=True, stream_weight_dtype="int8").save(
        os.path.join(stream_dir, "args.json"))
    st_files, st_spy, st_launches, st_wall = run_eval_cli(
        evaluate_iq.main, stream_dir, os.path.join(root, "eval_stream"),
        "--num-z-samples", "1")
    if st_launches != {**{k: 0 for k in LAYER_KERNELS},
                       "decode_stack_step": steps * nbatch,
                       "head_argmax": 0}:
        raise AssertionError(f"stream evaluation launches {st_launches}")
    trainer = st_spy.trainers[0]
    images, context = first_eval_batch(trainer, trainer.cfg, data["val"])
    direct = make_decode_step(trainer.cfg, trainer.model, True)(
        images, context, trainer._key(0))["tokens"]
    if not torch.equal(direct, st_spy.calls[0][0]):
        raise AssertionError("the stream evaluation's tokens differ from a "
                             "direct make_decode_step call")
    st_ms = st_spy.decode_ms(st_spy.calls)
    same = sum(a == b for a, b in zip(st_files["preds"], files["preds"]))
    log(f"[16] stream evaluation (int8 stack weights, the probe keeps the "
        f"head off the fused kernel): launches {st_launches} = {steps} x "
        f"{nbatch}; batch 0's tokens equal a direct make_decode_step call; "
        f"{same}/{EVAL_QUESTIONS} questions equal to the per-layer bf16 "
        f"path's; Bleu_4 {st_files['results']['Bleu_4']:.4g}")
    log(f"[16] {card}: stream evaluation decode {EVAL_QUESTIONS / st_ms * 1e3:.1f} "
        f"questions/s by events ({st_ms:.1f} ms; calls "
        f"{[round(x, 1) for x in st_spy.call_ms(st_spy.calls)]} ms, the "
        f"first building the int8 weight stacks); restore "
        f"{st_spy.restore_s[0]:.2f} s, NLG scoring {st_spy.nlg_s[0]:.2f} s "
        f"(host clock); the CLI run {st_wall:.1f} s")
    del trainer, st_spy, images, context
    torch.cuda.empty_cache()

    # ---- cli.tune: two trials of the reference space as children on card 0
    c = serve.flagship_config()
    tune_dir = os.path.join(root, "tune")
    argv = [f"--emb_dim={c.emb_dim}", f"--input_mode={c.input_mode}",
            f"--dtype={c.dtype}", f"--image_size={c.image_size}",
            f"--seed={SEED}", "--use_pallas_attention",
            "--attention_dropout=0.0", "--num_pretraining_steps=2",
            "--total_training_steps=4", "--val_check_interval=1000",
            "--checkpoint_every=1000", "--limit_val_batches=1",
            f"--vocab={data['vocab']}", f"--dataset={data['train']}",
            f"--val_dataset={data['val']}", "--tune-space", "reference",
            "--num-samples", "2", "--parallel", "2", "--tune-dir", tune_dir,
            "--slot-env", "0:CUDA_VISIBLE_DEVICES=0",
            "--slot-env", "1:CUDA_VISIBLE_DEVICES=0"]
    tune_log = os.path.join(root, "tune.log")
    t0 = time.perf_counter()
    rc = tune_cli_run(argv, tune_log)
    tune_s = time.perf_counter() - t0
    with open(tune_log) as f:
        text = f.read()
    devices = re.findall(r"^tune trial (\S+): device (\S+) \((.*)\)$", text,
                         re.M)
    walls = re.findall(r"^tune trial (\S+) to step (\d+): val loss (\S+) in "
                       r"(\S+) s$", text, re.M)
    analysis_path = os.path.join(tune_dir, "analysis.json")
    if rc != 0 or not os.path.exists(analysis_path):
        raise AssertionError(f"cli.tune returned {rc}; its output ends:\n"
                             + text[-4000:])
    with open(analysis_path) as f:
        analysis = json.load(f)
    trials = analysis["trials"]
    if (len(trials) != 2 or analysis["best_trial"] not in (0, 1)
            or any(t["metric"] is None or not math.isfinite(t["metric"])
                   or t["step"] not in (2, 4) for t in trials)):
        raise AssertionError(f"tune analysis {analysis}; output ends:\n"
                             + text[-4000:])
    for t in trials:
        for rung in (2, 4)[:(2, 4).index(t["step"]) + 1]:
            with open(os.path.join(tune_dir, f"trial_{t['id']}",
                                   f"result_{rung}.json")) as f:
                m = json.load(f)["metric"]
            if not math.isfinite(m):
                raise AssertionError(f"trial {t['id']} rung {rung}: {m}")
    if (len(devices) != len(walls) or len(walls) < 3
            or {d for _, d, _ in devices} != {"cuda"}
            or {os.path.basename(d) for d, _, _ in devices}
            != {"trial_0", "trial_1"}):
        raise AssertionError(f"tune children: devices {devices}, reports "
                             f"{walls}")
    log(f"[16] cli.tune (reference space, 2 samples, --parallel 2 on card "
        f"0, rungs 2 and 4): best trial {analysis['best_trial']}, " + "; ".join(
            f"trial {t['id']} {t['overrides']['hidden_dim']}x"
            f"{t['overrides']['num_heads']}h x{t['overrides']['num_layers']} "
            f"b{t['overrides']['batch_size']} to step {t['step']}, val loss "
            f"{t['metric']:.5g}" for t in trials))
    on = {d: name for d, _, name in devices}
    log(f"[16] {card}: tune children (host clock) " + "; ".join(
        f"{os.path.basename(d)} to step {s}: {float(w):.1f} s on {on[d]}"
        for d, s, _, w in walls) + f"; the tune run {tune_s:.1f} s")
    log(f"[16] phase 16 took {time.perf_counter() - t_phase:.1f} s")


def eval_cli_only(dev, card, log):
    """``--eval-cli-only``: the 6-step train CLI run phase 16 needs (no
    validation inside fit), then phase 16."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="eval_cli_")
    try:
        data = cli_data(root, log, "16")
        out = os.path.join(root, "run")
        t0 = time.perf_counter()
        r, _ = run_train_cli(train_cli_argv(data, out, 6,
                                            "--val_check_interval=1000"))
        if r["state"].step != 6:
            raise AssertionError(f"train CLI run ended at {r['state'].step}")
        del r
        log(f"[16] the 6-step train CLI run in "
            f"{time.perf_counter() - t0:.1f} s")
        eval_cli_phase(dev, card, log, data, out)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 17: the model variants and the train-step options

# hidden 1024 over 4 heads, head dim 256: the reference tune space's widest
# heads (train/tune.py default_search_space)
DH256_HEADS, DH256_DIM = 4, 256
DH256_EXTRA = ("B 8 T 512 causal, scattered pads",
               (8, DH256_HEADS, DH256_DIM, 512, 512, True), "random")
# flash launches of one latent train step (6 context, 6 posterior and 12
# decoder attention calls)
STEP_FLASH = 24
MOE = dict(moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
           moe_every=1)
# MoE: the flash path against the einsum path after a latent step.  The
# two paths round attention at different places; the router turns that
# into another expert (and, past a full expert's capacity, a dropped
# token) for a token near a routing tie, which phase 7's dense model has
# no counterpart of.  Readings over 4 weight/batch seeds (NVIDIA H100 80GB
# HBM3, 700 W): loss up to 3.56e-4 relative, grad_norm up to 7.58e-3
# (phase 7's limits hold the head-dim-256 model over the same 4 seeds:
# 2.64e-5 and 3.65e-4); parameters 0 of their motion after one step.
MOE_LOSS_REL = 8e-4
MOE_GNORM_REL = 1.5e-2
RNN_CELLS = ("lstm", "gru")


def all_launches() -> dict:
    """Every kernel wrapper's launch count."""
    return {**flash_launches(), **layer_launches(),
            **{name: getattr(ra, name).launches for name in RING_KERNELS},
            "decode_stack_step": stack_launches(),
            "head_argmax": decode_head.head_argmax.launches,
            "int8_matmul": i8mm.int8_matmul.launches}


def zero_all_launches() -> None:
    zero_flash_launches()
    zero_layer_launches()
    for name in RING_KERNELS:
        getattr(ra, name).launches = 0
    decode_stream.decode_stack_step.launches = 0
    decode_head.head_argmax.launches = 0
    i8mm.int8_matmul.launches = 0


def launched(counts: dict) -> dict:
    """The kernels that launched, and how often."""
    return {k: v for k, v in counts.items() if v}


def timed(fn):
    """(fn's result, its milliseconds by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def flagship_states(dev, over: dict, seed: int, einsum: bool = True):
    """The flagship configuration with ``over`` on the flash kernels
    (attention dropout 0), its seed-made train state, and the same weights
    on the einsum path (with ``einsum``)."""
    cfg = serve.flagship_config().replace(use_pallas_attention=True,
                                          attention_dropout=0.0, **over)
    kstate = create_train_state(cfg, IQ(cfg, serve.FLAGSHIP_VOCAB).to(dev),
                                seed=seed)
    if not einsum:
        return cfg, kstate, None, None
    ecfg = cfg.replace(use_pallas_attention=False)
    emodel = IQ(ecfg, serve.FLAGSHIP_VOCAB).to(dev)
    emodel.load_state_dict(kstate.model.state_dict())
    return cfg, kstate, ecfg, create_train_state(ecfg, emodel, seed=None)


def variant_compare(dev, card, log, tag: str, over: dict, steps: int,
                    seed: int, limits):
    """``steps`` latent train steps of the flagship with ``over`` on the
    flash path against the einsum path, from the same weights, batch and
    generator seeds (made from ``seed``), held to ``limits`` (loss,
    grad_norm, parameters: relative); exact flash launches.  Returns (the
    flash path's last metrics, its state, the batch)."""
    cfg, kstate, ecfg, estate = flagship_states(dev, over, seed)
    batch = make_batch(cfg, serve.FLAGSHIP_VOCAB, BATCH,
                       np.random.RandomState(seed + 200), dev)
    theta0 = flat_params(estate.model)
    gens = [torch.Generator(dev).manual_seed(seed + 300) for _ in range(2)]
    worst = {"loss": 0.0, "gnorm": 0.0, "param": 0.0}
    zero_all_launches()
    step_k, step_e = (make_train_step(c, True) for c in (cfg, ecfg))
    for i in range(steps):
        mk, ms = timed(lambda: step_k(kstate, batch, gens[0])[1])
        counts = launched(all_launches())
        me = step_e(estate, batch, gens[1])[1]
        mk = {n: float(v) for n, v in mk.items()}
        me = {n: float(v) for n, v in me.items()}
        if not all(math.isfinite(v) for v in (*mk.values(), *me.values())):
            raise AssertionError(f"[{tag}] step {i}: non-finite {mk} {me}")
        if not mk["kld"] > 0.0:
            raise AssertionError(f"[{tag}] latent step {i}: kld {mk['kld']}")
        loss_rel = abs(mk["loss"] - me["loss"]) / abs(me["loss"])
        gnorm_rel = abs(mk["grad_norm"] - me["grad_norm"]) / me["grad_norm"]
        theta_k, theta_e = flat_params(kstate.model), flat_params(estate.model)
        param_rel = float((theta_k - theta_e).norm()
                          / (theta_e - theta0).norm().clamp_min(1e-30))
        del theta_k, theta_e
        for key, val in zip(worst, (loss_rel, gnorm_rel, param_rel)):
            worst[key] = max(worst[key], val)
        log(f"[{tag}] {card}: latent step {i}: {ms:.2f} ms by events on the "
            f"flash path, launches {counts}; loss {mk['loss']:.6g} (einsum "
            f"{me['loss']:.6g}), kld {mk['kld']:.5g}, grad_norm "
            f"{mk['grad_norm']:.6g}" + "".join(
                f", {k} {mk[k]:.5g}" for k in ("moe_balance", "moe_router_z")
                if k in mk) + f"; relative: loss {loss_rel:.3g}, grad_norm "
            f"{gnorm_rel:.3g}, parameters {param_rel:.3g} of their motion")
        want = {k: STEP_FLASH * (i + 1) for k in FLASH_KERNELS}
        if counts != want:
            raise AssertionError(f"[{tag}] launches {counts}, want {want}")
    log(f"[{tag}] seed {seed}: flash path against einsum path, worst: loss "
        f"{worst['loss']:.3g}, grad_norm {worst['gnorm']:.3g}, parameters "
        f"{worst['param']:.3g} (limits {limits})")
    if not all(w <= lim for w, lim in zip(worst.values(), limits)):
        raise AssertionError(f"[{tag}] flash path against einsum path: "
                             f"{worst} (limits {limits})")
    del estate
    return mk, kstate, batch


def compare_seeds(dev, card, log, tag: str, over: dict, seeds: int, limits):
    """variant_compare over ``seeds`` weight/batch seeds, the first kept
    (run last); the readings of every seed are printed before any limit
    fails."""
    failed = []
    for i in range(seeds - 1, -1, -1):
        try:
            out = variant_compare(dev, card, log, tag, over, 1, SEED + i,
                                  limits)
        except AssertionError as e:
            failed.append(str(e))
        if i:
            out = None
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def fwd256_ptxas(log) -> None:
    """The compiler's registers, barriers and spills of the two head-dim-256
    forwards, from the build log (phase 1 refuses their spills)."""
    with open(_build.library_path() + ".log") as f:
        report = f.read()
    for name, used, spill in ptxas_entries(report):
        if DMAX256 in name and any(k in name for k in FWD256):
            log(f"[17a] ptxas {name}: {used.group(0) if used else '?'}; "
                f"spill stores {spill.group(1) if spill else '?'} bytes")


def dh256_times(dev, card, log):
    """17a's times at head dim 256 (H 4): the flash kernels over a latent
    step's 24 calls and one call at DH256_EXTRA, the ring functions at the
    training and the long shape.  Returns (flash totals, ring times per
    call at the training shape)."""
    ftot = flash_timings(dev, card, log, DH256_HEADS, DH256_DIM, "17a",
                         multi=False)
    what, (b, h, d, tq, tk, causal), pad = DH256_EXTRA
    t, bounds = flash_shape_times(dev, b, h, d, tq, tk, causal, pad, 10)
    log(flash_shape_line(card, f"Dh 256 {what} (B {b}, H {h})", t, "17a")
        + "; bounds: " + ", ".join(
            f"{name} {bound(*nb)[0] * 1e3:.2f} us ({bound(*nb)[1]})"
            for name, nb in bounds.items()))
    rtimes = ring_case_times(dev, card, log, "training", RING_TRAIN_CASE,
                             DH256_HEADS, DH256_DIM, "17a")
    ring_case_times(dev, card, log, "long", RING_LONG_CASE, DH256_HEADS,
                    DH256_DIM, "17a")
    return ftot, rtimes


def fwd256_launches(fn):
    """{forward: (launches, device ms)} of the two head-dim-256 forwards
    (their ILi256E instantiations, which the profiler names demangled:
    ``bvq::flash_fwd_mma_kernel<256>(...)``) in one call of ``fn``, by
    profiler."""
    out = {k: (0.0, 0.0) for k in FWD256}
    for name, (n, t) in profile_groups(fn, 1).items():
        for k in FWD256:
            if f"{k}<256>" in name or (k in name and DMAX256 in name):
                out[k] = (out[k][0] + n, out[k][1] + t)
    return out


def dh256_phase(dev, card, log, data: dict, seeds: int):
    """17(a): the flash and ring kernels at head dim 256 against their
    plain versions (the ring also at the long shape) and timed; the
    flagship at hidden 1024 over 4 heads trained on the flash path against
    the einsum path, and the head-dim-256 forwards' launches in a latent
    step on the flash path and on the seq 4 ring path, by profiler; a
    ``cli.tune`` child of that trial.  Returns (flash totals, ring times
    per call, worst errors by function)."""
    fwd256_ptxas(log)
    worst = dict.fromkeys(FLASH_KERNELS + RING_KERNELS, 0.0)
    cases = [(f"{what} Tq {tq} Tk {tk}{' causal' if causal else ''}",
              (BATCH, DH256_HEADS, DH256_DIM, tq, tk, causal), "tail")
             for what, tq, tk, causal, _ in FLASH_SHAPES] + [DH256_EXTRA]
    for what, (b, h, d, tq, tk, causal), pad in cases:
        q, k, v, kv_pad, do = flash_inputs(dev, b, h, d, tq, tk, causal,
                                           SEED + 17, pad)
        errs, ulps, norm, ml = check_flash_case(q, k, v, kv_pad, do, causal,
                                                f"Dh 256 {what}")
        for name, val in errs.items():
            worst[name] = max(worst[name], val)
        log(f"[17a] flash Dh 256 {what} (B {b}, H {h}): max err {ulps:.3g} "
            f"bf16 ulps, relative norm error {norm:.3g}, m/l relative error "
            f"{ml:.3g} (limits {FLASH_MAX_ULPS}, {FLASH_REL_NORM}, "
            f"{FLASH_ML_REL})")
    for what, b, n, c, causal, pad in (RING_TRAIN_CASE, RING_LONG_CASE):
        q, k, v, kv_pad, do = ring_inputs(dev, b, n, c, pad, SEED + 17,
                                          DH256_DIM, DH256_HEADS)
        errs, ulps, norm, ml, _, _ = check_ring_case(q, k, v, kv_pad, do, n,
                                                     causal, f"Dh 256 {what}")
        for name, val in errs.items():
            worst[name] = max(worst[name], val)
        log(f"[17a] ring Dh 256 {what} (B {b}, H {DH256_HEADS}), one-way and "
            f"two-way: max err {ulps:.3g} bf16 ulps, relative norm error "
            f"{norm:.3g}, m/l relative error {ml:.3g} (limits "
            f"{RING_MAX_ULPS}, {RING_REL_NORM}, {RING_ML_REL})")
        del q, k, v, kv_pad, do
    ftot, rtimes = dh256_times(dev, card, log)

    _, kstate, batch = compare_seeds(dev, card, log, "17a",
                                     dict(num_heads=DH256_HEADS), seeds,
                                     (TRAIN_LOSS_REL, TRAIN_GNORM_REL,
                                      TRAIN_PARAM_REL))
    # the head-dim-256 forwards of a latent step, by profiler: on the flash
    # path, then with the decoder's self-attentions on the seq 4 ring
    cfg = kstate.model.cfg
    gen = torch.Generator(dev).manual_seed(SEED + 18)
    step = make_train_step(cfg, True)
    got = fwd256_launches(lambda: step(kstate, batch, gen))
    scfg = cfg.replace(sequence_parallel=True, ring_attention_impl="pallas")
    mesh = build_mesh((RING_SEQ,), ("seq",), dev)
    smodel = IQ(scfg, serve.FLAGSHIP_VOCAB, mesh).to(dev)
    smodel.load_state_dict(kstate.model.state_dict())
    sstate = create_train_state(scfg, smodel, seed=None)
    sstep = make_train_step(scfg, True, mesh)
    metrics = {}
    sp = fwd256_launches(lambda: metrics.update(
        sstep(sstate, batch, gen)[1]))
    nl = cfg.num_layers
    want = {"flash": {FWD256[0]: STEP_FLASH, FWD256[1]: 0},
            "seq 4": {FWD256[0]: STEP_FLASH - nl,
                      FWD256[1]: nl * ring_launch_counts(RING_SEQ, True)[0]}}
    for path, counts in (("flash", got), ("seq 4", sp)):
        log(f"[17a] {card}: latent step b{BATCH} on the {path} path, the "
            f"{DMAX256} forwards by profiler: " + ", ".join(
                f"{k}<256> {n:.0f} launches, {t * 1e3:.1f} us device"
                for k, (n, t) in counts.items()))
        if {k: round(n) for k, (n, _) in counts.items()} != want[path]:
            raise AssertionError(f"[17a] {path} path: {DMAX256} forward "
                                 f"launches {counts}, want {want[path]}")
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"[17a] seq 4 latent step: {metrics}")
    del kstate, sstate, smodel, batch
    torch.cuda.empty_cache()

    # a cli.tune trial child on that trial: the flagship widths over 4 heads
    from blt_vqg_tpu_torch.train.tune import result_path
    trial = os.path.join(data["root"], "tune_dh256")
    os.makedirs(trial)
    c = serve.flagship_config()
    tcfg = c.replace(num_heads=DH256_HEADS, use_pallas_attention=True,
                     attention_dropout=0.0, batch_size=BATCH,
                     num_pretraining_steps=1, total_training_steps=2,
                     val_check_interval=1000, checkpoint_every=1000,
                     limit_val_batches=1, seed=SEED, vocab=data["vocab"],
                     dataset=data["train"], val_dataset=data["val"],
                     output_dir=trial)
    cfg_path = os.path.join(trial, "trial.json")
    with open(cfg_path, "w") as f:
        f.write(tcfg.to_json())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "blt_vqg_tpu_torch.cli.tune", "--run-trial",
         "--trial-config", cfg_path, "--trial-dir", trial,
         "--stop-at-step", "2", "--device", "cuda"],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    res = result_path(trial, 2)
    if proc.returncode != 0 or not os.path.exists(res):
        raise AssertionError(f"tune child (hidden 1024 x 4 heads) returned "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    with open(res) as f:
        metric = json.load(f)["metric"]
    if not math.isfinite(metric):
        raise AssertionError(f"tune child: val loss {metric}")
    log(f"[17a] {card}: cli.tune child, hidden 1024 x 4 heads (head dim "
        f"256) x 6 layers b{BATCH}, use_pallas_attention, to step 2: val "
        f"loss {metric:.5g} in {wall:.1f} s (host clock, the process "
        f"included)")
    return ftot, rtimes, worst


def vit_phase(dev, card, log, data: dict):
    """17(b): BASELINE config 4, the ViT-B/16 image encoder: the train CLI
    (2 pretrain, 2 latent steps, the flash kernels, one validation on the
    per-layer kernels), then the directory served at b64 on the stream
    path with int8 stack weights and the fused head."""
    out = os.path.join(data["root"], "vit")
    zero_all_launches()
    t0 = time.perf_counter()
    r, text = run_train_cli(train_cli_argv(
        data, out, 4, "--image_encoder=vit_b16", "--val_check_interval=1000",
        "--checkpoint_every=1000"))
    wall = time.perf_counter() - t0
    counts = launched(all_launches())
    trainer, state = r["trainer"], r["state"]
    if (state.step, state.kliter) != (4, 2):
        raise AssertionError(f"ViT run: step {state.step}, kliter "
                             f"{state.kliter}")
    if type(trainer.model.encoder_cnn).__name__ != "ViTEncoder":
        raise AssertionError("the ViT run did not build the ViT encoder")
    for s, m in trainer.history:
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()) or (
                (m["kld"] > 0.0) != (s > 2)):
            raise AssertionError(f"ViT run, step {s}: {m}")
        log(f"[17b] ViT-B/16 after step {s}: loss {m['loss']:.6g}, kld "
            f"{m['kld']:.5g}, grad_norm {m['grad_norm']:.5g}")
    steps = serve.flagship_config().max_decode_length + 1
    layers = serve.flagship_config().num_layers
    want = {"flash_attention_fwd": 2 * 18 + 2 * 24 + VAL_FLASH_FWD,
            "flash_attention_bwd_dkdv": 2 * 18 + 2 * 24,
            "flash_attention_bwd_dq": 2 * 18 + 2 * 24,
            **{k: VAL_DECODES * steps * layers for k in LAYER_KERNELS}}
    if counts != want:
        raise AssertionError(f"ViT run launches {counts}, want {want}")
    tm = trainer.timings
    log(f"[17b] {card}: ViT-B/16 train CLI, 4 steps of b{BATCH} in "
        f"{tm['fit_ms'][0]:.1f} ms by events (dispatches "
        f"{[round(x, 1) for x in tm['dispatch_ms']]} ms, the validation "
        f"{[round(x, 1) for x in tm['validate_ms']]} ms host clock); launches "
        f"{counts}; the CLI run {wall:.1f} s")
    del r, trainer, state
    torch.cuda.empty_cache()

    cfg, model, latent = serve.build_model(out, stream=True,
                                           stream_weight_dtype="int8",
                                           device=dev)
    if not (latent and model.fused_head_engaged(with_probe=False)):
        raise AssertionError("the ViT directory must serve in latent mode "
                             "on the fused head")
    # serve_rounds' decode step on one request batch, after a warm-up
    decode = make_decode_step(cfg, model, latent_mode=latent,
                              with_probe=False)
    images, context = serve.make_requests(np.random.RandomState(SEED + 3),
                                          BATCH, cfg, dev)
    decode(images, context, torch.Generator(dev).manual_seed(0))
    zero_all_launches()
    res, ms = timed(lambda: decode(images, context,
                                   torch.Generator(dev).manual_seed(1)))
    counts = launched(all_launches())
    check_tokens(res["tokens"], BATCH, steps, model.vocab_size, "ViT serve")
    # the context encoder's flash forward once a batch, then a stack step
    # and a head call a decode step
    want = {"flash_attention_fwd": cfg.num_layers,
            "decode_stack_step": steps, "head_argmax": steps}
    if counts != want:
        raise AssertionError(f"ViT serve launches {counts}, want {want}")
    log(f"[17b] {card}: ViT-B/16 served b{BATCH} on the stream path (int8 "
        f"stack, int8 fused head): {ms:.2f} ms by events = "
        f"{BATCH / ms * 1e3:.1f} q/s; launches {counts}")
    del model, decode
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()


def moe_routing(dev, card, log, seed: int) -> None:
    """17(c), routing: one latent step of the MoE flagship on the flash and
    the einsum paths from the same weights, batch and generator seeds;
    counts, for each router call (a layer's forward), the tokens whose
    top-2 experts differ between the paths.  Then the flash path's step
    again from the same fresh state with every router call pinned to the
    einsum path's choice (``ops.moe.top_k`` patched here: each call returns
    the einsum call's experts, gated by this path's own probabilities), held
    to phase 7's dense limits (loss, grad_norm)."""
    from blt_vqg_tpu_torch.ops import moe

    cfg, kstate, ecfg, estate = flagship_states(dev, MOE, seed)
    batch = make_batch(cfg, serve.FLAGSHIP_VOCAB, BATCH,
                       np.random.RandomState(seed + 200), dev)
    top_k = moe.top_k
    chosen = {"einsum": [], "flash": []}

    def recorder(into):
        def rec(x, k):
            out = top_k(x, k)
            into.append(out[1].clone())
            return out
        return rec

    def step(c, state, router):
        moe.top_k = router
        try:
            m = make_train_step(c, True)(
                state, batch, torch.Generator(dev).manual_seed(seed + 300))[1]
        finally:
            moe.top_k = top_k
        return {n: float(v) for n, v in m.items()}

    me = step(ecfg, estate, recorder(chosen["einsum"]))
    mk = step(cfg, kstate, recorder(chosen["flash"]))
    del estate, kstate
    calls = len(chosen["einsum"])
    if len(chosen["flash"]) != calls or not calls:
        raise AssertionError(f"[17c] router calls: einsum {calls}, flash "
                             f"{len(chosen['flash'])}")
    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for a, b in zip(chosen["einsum"], chosen["flash"])]
    pins = iter(chosen["einsum"])

    def pinned(x, k):
        idx = next(pins)
        return torch.gather(x, 1, idx), idx

    fresh = flagship_states(dev, MOE, seed, einsum=False)[1]
    mp = step(cfg, fresh, pinned)
    del fresh
    if next(pins, None) is not None:
        raise AssertionError("[17c] the pinned step made fewer router calls")
    rel = {tag: (abs(m["loss"] - me["loss"]) / abs(me["loss"]),
                 abs(m["grad_norm"] - me["grad_norm"]) / me["grad_norm"])
           for tag, m in (("free", mk), ("pinned", mp))}
    tokens = sorted({c.shape[0] for c in chosen["einsum"]})
    log(f"[17c] {card}: MoE routing, flash against einsum path (seed {seed}, "
        f"one latent step): tokens whose top-2 experts differ, per router "
        f"call ({calls} calls of {'/'.join(map(str, tokens))} tokens): "
        f"{flips} ({sum(flips)} in all); routed freely: loss "
        f"{rel['free'][0]:.3g}, grad_norm {rel['free'][1]:.3g}; routing "
        f"pinned to the einsum path's choice: loss {rel['pinned'][0]:.3g}, "
        f"grad_norm {rel['pinned'][1]:.3g} (phase 7's limits "
        f"{TRAIN_LOSS_REL}, {TRAIN_GNORM_REL})")
    if not (rel["pinned"][0] <= TRAIN_LOSS_REL
            and rel["pinned"][1] <= TRAIN_GNORM_REL):
        raise AssertionError(f"[17c] MoE with pinned routing against the "
                             f"einsum path: {rel['pinned']}")
    torch.cuda.empty_cache()


def moe_phase(dev, card, log, seeds: int):
    """17(c): MoE FFNs (8 experts, top 2, capacity 1.25, every layer): the
    routing flips and the routing-pinned step (:func:`moe_routing`), a
    latent step on the flash path against the einsum path, the balance
    and router-z losses finite and in the loss, greedy b64 on the plain
    decode path, and the kernel decode paths' refusals."""
    from blt_vqg_tpu_torch.train.step import (_forward, _losses,
                                              collect_moe_losses)

    moe_routing(dev, card, log, SEED)
    _, kstate, batch = compare_seeds(dev, card, log, "17c", MOE, seeds,
                                     (MOE_LOSS_REL, MOE_GNORM_REL,
                                      TRAIN_PARAM_REL))
    cfg = kstate.model.cfg
    # the losses enter the loss: a forward and a step from one generator
    # state give base + weights x (balance, router_z) and the step's loss
    losses = []
    with torch.no_grad():
        outputs = _forward(kstate, batch, True, True,
                           torch.Generator(dev).manual_seed(5), None,
                           moe_losses=losses)
        base = float(_losses(cfg, kstate, batch, outputs, True).loss)
    m = make_train_step(cfg, True)(kstate, batch,
                                   torch.Generator(dev).manual_seed(5))[1]
    bal, rz = (float(x) for x in collect_moe_losses(losses, dev))
    total = base + cfg.moe_aux_weight * bal + cfg.moe_router_z_weight * rz
    if not (len(losses) == 3 * cfg.num_layers and math.isfinite(total)
            and abs(float(m["loss"]) - total) <= 1e-4 * abs(total)
            and float(m["moe_balance"]) > 0 and float(m["moe_router_z"]) > 0):
        raise AssertionError(f"MoE losses: {len(losses)} layers, base {base},"
                             f" balance {bal}, router_z {rz}, step {m}")
    log(f"[17c] MoE losses over {len(losses)} layers: balance {bal:.5g}, "
        f"router_z {rz:.5g}; the step's loss {float(m['loss']):.6g} = base "
        f"{base:.6g} + {cfg.moe_aux_weight} x balance + "
        f"{cfg.moe_router_z_weight} x router_z")
    model = kstate.model.eval()
    images, context = serve.make_requests(np.random.RandomState(SEED + 7),
                                          BATCH, cfg, dev)
    decode = make_decode_step(cfg, model, latent_mode=True, with_probe=False)
    zero_all_launches()
    out, ms = timed(lambda: decode(images, context,
                                   torch.Generator(dev).manual_seed(1)))
    steps = cfg.max_decode_length + 1
    check_tokens(out["tokens"], BATCH, steps, model.vocab_size, "MoE greedy")
    log(f"[17c] {card}: MoE greedy b{BATCH} on the plain decode path: "
        f"{ms:.2f} ms by events = {BATCH / ms * 1e3:.1f} q/s; launches "
        f"{launched(all_launches())}")
    for path in ("use_pallas_decode", "use_stream_decode"):
        try:
            IQ(cfg.replace(**{path: True}), serve.FLAGSHIP_VOCAB)
        except ValueError as e:
            log(f"[17c] MoE with {path} refused: {e}")
        else:
            raise AssertionError(f"MoE with {path} was not refused")
    del kstate, model
    torch.cuda.empty_cache()


def rnn_phase(dev, card, log):
    """17(d): the RNN family (LSTM, then GRU) at the flagship's widths: 2
    pretrain and, after the Adam restart, 1 latent step, then greedy b64;
    it runs no hand-written kernel."""
    from blt_vqg_tpu_torch.models.iq_rnn import IQRNN

    for cell in RNN_CELLS:
        cfg = serve.flagship_config().replace(model_family="rnn",
                                              rnn_cell=cell)
        state = create_train_state(cfg, IQRNN(cfg, serve.FLAGSHIP_VOCAB).to(
            dev), seed=SEED)
        batch = make_batch(cfg, serve.FLAGSHIP_VOCAB, BATCH,
                           np.random.RandomState(SEED + 9), dev)
        gen = torch.Generator(dev).manual_seed(SEED + 10)
        zero_all_launches()
        for i, latent in enumerate((False, False, True)):
            if i == 2:
                state.reset_optimizer()
            m, ms = timed(lambda: make_train_step(cfg, latent)(state, batch,
                                                               gen)[1])
            m = {k: float(v) for k, v in m.items()}
            if not all(math.isfinite(v) for v in m.values()) or (
                    (m["kld"] > 0.0) != latent):
                raise AssertionError(f"{cell} step {i}: {m}")
            kind = "latent" if latent else "pretrain"
            log(f"[17d] {card}: {cell.upper()} {kind} step {i}: {ms:.2f} ms "
                f"by events; loss "
                f"{m['loss']:.6g}, kld {m['kld']:.5g}, grad_norm "
                f"{m['grad_norm']:.5g}")
        decode = make_decode_step(cfg, state.model.eval(), latent_mode=True)
        images, context = serve.make_requests(
            np.random.RandomState(SEED + 11), BATCH, cfg, dev)
        out, ms = timed(lambda: decode(images, context,
                                       torch.Generator(dev).manual_seed(1)))
        check_tokens(out["tokens"], BATCH, cfg.max_decode_length + 1,
                     serve.FLAGSHIP_VOCAB, f"{cell} greedy")
        log(f"[17d] {card}: {cell.upper()} greedy b{BATCH}: {ms:.2f} ms by "
            f"events = {BATCH / ms * 1e3:.1f} q/s; launches over the phase "
            f"{launched(all_launches()) or 'none (no kernel on this path)'}")
        del state, decode
        torch.cuda.empty_cache()


def options_phase(dev, card, log, root: str):
    """17(e): 3 latent steps with bf16 gradients and 3 with the unfused
    optax chain (f32 parameters) on the flash path; a ``fused_adam=False``
    checkpoint saved and restored bit for bit."""
    from blt_vqg_tpu_torch.core.checkpoint import (CheckpointManager,
                                                   flatten_state)

    for over in ({"grad_dtype": "bfloat16"}, {"fused_adam": False}):
        cfg, state, _, _ = flagship_states(dev, over, SEED, einsum=False)
        batch = make_batch(cfg, serve.FLAGSHIP_VOCAB, BATCH,
                           np.random.RandomState(SEED + 13), dev)
        gen = torch.Generator(dev).manual_seed(SEED + 14)
        step = make_train_step(cfg, True)
        zero_all_launches()
        for i in range(3):
            m, ms = timed(lambda: step(state, batch, gen)[1])
            m = {k: float(v) for k, v in m.items()}
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{over} step {i}: {m}")
            log(f"[17e] {card}: {over} latent step {i}: {ms:.2f} ms by "
                f"events, launches {launched(all_launches())}; loss "
                f"{m['loss']:.6g}, grad_norm {m['grad_norm']:.6g}")
        if launched(all_launches()) != {k: 3 * STEP_FLASH
                                        for k in FLASH_KERNELS}:
            raise AssertionError(f"{over}: launches {all_launches()}")
        if not cfg.fused_adam:
            path = os.path.join(root, "chain_ckpt")
            mgr = CheckpointManager(path)
            t0 = time.perf_counter()
            mgr.save(state, cfg)
            save_s = time.perf_counter() - t0
            fresh = create_train_state(cfg, IQ(cfg, serve.FLAGSHIP_VOCAB).to(
                dev), seed=SEED + 1)
            t0 = time.perf_counter()
            back = mgr.restore(fresh)
            restore_s = time.perf_counter() - t0
            a, b = flatten_state(state), flatten_state(back)
            if not any("inner_states/train" in k for k in a):
                raise AssertionError("the chain's state layout is missing")
            same_entries(a, b, "fused_adam=False checkpoint")
            log(f"[17e] fused_adam=False checkpoint (the optax chain's "
                f"layout, {len(a)} entries) saved in {save_s:.1f} s and "
                f"restored in {restore_s:.1f} s (host clock), bit for bit")
            del fresh, back, a, b
            shutil.rmtree(path, ignore_errors=True)
        del state
        torch.cuda.empty_cache()


def variants_phase(dev, card, log, seeds: int = 1):
    """Phase 17: (a) head dim 256, (b) ViT-B/16, (c) MoE, (d) the RNN
    family, (e) the train-step options.  Returns 17(a)'s (flash totals,
    ring times per call, worst errors)."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="variants_")
    try:
        data = cli_data(root, log, "17")
        data["root"] = root
        parts = {}
        t0 = time.perf_counter()
        dh256 = dh256_phase(dev, card, log, data, seeds)
        parts["a"] = time.perf_counter() - t0
        for key, fn in (("b", lambda: vit_phase(dev, card, log, data)),
                        ("d", lambda: rnn_phase(dev, card, log)),
                        ("e", lambda: options_phase(dev, card, log, root)),
                        ("c", lambda: moe_phase(dev, card, log, seeds))):
            t0 = time.perf_counter()
            fn()
            parts[key] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[17] phase 17 took {time.perf_counter() - t_phase:.1f} s (host "
        f"clock; by part: " + ", ".join(f"({k}) {v:.1f} s"
                                        for k, v in parts.items()) + ")")
    return dh256



# ---------------------------------------------------------------------------
# data and tensor parallelism across processes (phase 18)

# flash launches of the fit loop of phase 18a: 2 pretrain steps (context
# encoder 6 + decoder 12 attention calls) and 2 latent steps (24 calls)
PAR_FIT_FLASH = 2 * 18 + 2 * 24
# the 2-process step against the 1-process step on the same weights, batch
# and generator: loss and grad norm relative; batch-norm statistics and
# updated parameters relative to each tensor's largest magnitude; first
# moments ((1 - b1) x the gradients) relative to the largest moment.  bf16
# compute: the rows or heads split change the products' rounding.
# Readings over 3 seeds (NVIDIA H100 80GB HBM3, 700.00 W), data 2 / model 2:
# loss 1.06e-4 / 3.49e-5, grad norm 9.64e-4 / 1.41e-3, statistics 6.85e-4 /
# 0, parameters 0 / 0 (a first Adam step moves each element by about lr,
# whatever its gradient's size), moments 0.0577 / 0.0448 (the latent nets'
# and fc's small gradients: 11.6% of the posterior net's own largest).  The
# one-process step with another generator (other dropout masks) must fail
# the loss limit.
PAR_LIMITS = {"loss": 3e-4, "grad_norm": 4e-3, "bn": 2e-3, "params": 1e-3,
              "mu": 0.15}
PAR_TIMED_STEPS = 2


def parallel_cli_argv(data: dict, out: str, *extra) -> list:
    """The flagship on the train CLI for 2 pretrain and 2 latent steps on
    the flash kernels, no validation inside the fit loop, a checkpoint at
    step 4 and the final validation on the per-layer kernels."""
    c = serve.flagship_config()
    return [f"--emb_dim={c.emb_dim}", f"--hidden_dim={c.hidden_dim}",
            f"--latent_dim={c.latent_dim}", f"--pwffn_dim={c.pwffn_dim}",
            f"--num_layers={c.num_layers}", f"--num_heads={c.num_heads}",
            f"--input_mode={c.input_mode}", f"--dtype={c.dtype}",
            f"--image_size={c.image_size}", f"--batch_size={BATCH}",
            "--use_pallas_attention", "--attention_dropout=0.0",
            "--use_pallas_decode", "--num_pretraining_steps=2",
            "--total_training_steps=4", "--steps_per_dispatch=2",
            "--val_check_interval=100", "--limit_val_batches=1",
            "--checkpoint_every=4", "--no_checkpoint_at_end",
            f"--seed={SEED}", f"--vocab={data['vocab']}",
            f"--dataset={data['train']}", f"--val_dataset={data['val']}",
            f"--output_dir={out}", *extra]


def _child_env() -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))


def parallel_cli_phase(dev, card, log, data: dict, root: str) -> dict:
    """Phase 18a: the flagship through ``torch.distributed.run
    --standalone --nproc_per_node 1 -m blt_vqg_tpu_torch.cli.train_iq``
    (NCCL at world 1), with ``--shard_opt_state`` and with ``--fsdp``:
    exit 0, a finite final validation, the flash kernels of the fit loop
    by profiler, the step-4 checkpoint restored bit for bit and written
    and read again through ``save_sharded``/``restore_sharded``."""
    from blt_vqg_tpu_torch.core.checkpoint import (CheckpointManager,
                                                   flatten_state)
    from blt_vqg_tpu_torch.core.config import Config
    out = {}
    for flag in ("--shard_opt_state", "--fsdp"):
        run_dir = os.path.join(root, flag.strip("-"))
        trace_dir = os.path.join(run_dir, "trace")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "blt_vqg_tpu_torch.cli.train_iq",
               *parallel_cli_argv(data, run_dir, flag,
                                  f"--profile_dir={trace_dir}")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=_child_env(), capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"[18a] train CLI {flag} exited "
                                 f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                                 f"{r.stderr[-3000:]}")
        if "backend nccl" not in r.stderr + r.stdout:
            raise AssertionError(f"[18a] {flag}: no NCCL world in the log")
        blocks = validation_blocks(r.stdout)
        final = blocks.get(4, [{}])[-1]
        if not final or not all(math.isfinite(v) for v in final.values()):
            raise AssertionError(f"[18a] {flag}: final validation {final}")
        kernels = trace_kernels(os.path.join(trace_dir, "trace.json"))
        fams = {}
        for name, n in kernels.items():
            fam = kernel_family(name, FLASH_STEP_KERNELS)
            fams[fam] = fams.get(fam, 0) + n
        bad = {k: fams.get(k, 0) for k in FLASH_MMA
               if not PROFILE_MIN_SHARE * PAR_FIT_FLASH <= fams.get(k, 0)
               <= PAR_FIT_FLASH}
        bad.update({k: fams[k] for k in FLASH_FMA if fams.get(k)})
        if bad:
            raise AssertionError(f"[18a] {flag}: flash kernels of the fit "
                                 f"loop {bad}, want {PAR_FIT_FLASH} each")
        out[flag] = {"wall_s": wall, "loss": final["loss"]}
        log(f"[18a] {card}: train CLI {flag} under torch.distributed.run "
            f"(NCCL, world 1): exit 0 in {wall:.1f} s (host clock, process "
            f"start included); final validation loss {final['loss']:.6g}, "
            f"Bleu_4 {final.get('Bleu_4', float('nan')):.4g}; fit loop flash "
            f"kernels " + ", ".join(f"{k} {fams.get(k, 0)}/{PAR_FIT_FLASH}"
                                    for k in FLASH_MMA))
    # the last run's rank-0 checkpoint, restored bit for bit, then sharded
    cfg = Config.load(os.path.join(run_dir, "args.json"))
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    state = ckpt.restore(create_train_state(
        cfg, IQ(cfg, serve.FLAGSHIP_VOCAB).to(dev), seed=None))
    with np.load(os.path.join(run_dir, "checkpoints", "step_4",
                              "state.npz")) as z:
        same_entries(flatten_state(state), {k: z[k] for k in z.files},
                     f"[18a] {flag}: the restored step-4 state")
    sharded = CheckpointManager(os.path.join(run_dir, "sharded"))
    t1 = time.perf_counter()
    sharded.save_sharded(state, cfg)
    back = sharded.restore_sharded(create_train_state(
        cfg, IQ(cfg, serve.FLAGSHIP_VOCAB).to(dev), seed=None))
    shard_s = time.perf_counter() - t1
    same_entries(flatten_state(back), flatten_state(state),
                 f"[18a] {flag}: the save_sharded round trip")
    files = sorted(os.listdir(os.path.join(run_dir, "sharded",
                                           "step_4")))
    log(f"[18a] {card}: the {flag} run's step-4 checkpoint restored bit "
        f"for bit; save_sharded + restore_sharded ({files}) bit-equal in "
        f"{shard_s:.1f} s (host clock)")
    del state, back
    torch.cuda.empty_cache()
    return out


def metric_rel(m: dict, want: dict, key: str) -> float:
    return abs(float(m[key]) - float(want[key])) / abs(float(want[key]))


def state_errors(state, ref, m: dict, ref_m: dict) -> dict:
    """A step's state and metrics against the one-process step's: loss and
    grad norm relative; batch-norm statistics and updated parameters
    relative to each tensor's largest magnitude; first moments relative to
    the largest moment (a gradient that is 0 in exact arithmetic, the fc
    bias before the train-mode batch norm, is rounding noise), with the
    three largest (name, of the largest moment, of its own max)."""
    pl = state.placement
    want_p = dict(ref.model.named_parameters())
    par = 0.0
    for name, p in state.model.named_parameters():
        w = pl.local(want_p[name].data, pl.store[name]).float()
        scale = float(w.abs().max()) or 1.0
        par = max(par, float((p.data.float() - w).abs().max()) / scale)
    want_b = dict(ref.model.named_buffers())
    bn = 0.0
    for name, b in state.model.named_buffers():
        w = want_b[name].float()
        scale = float(w.abs().max()) or 1.0
        bn = max(bn, float((b.float() - w).abs().max()) / scale)
    want_mu = pl.place_opt(ref.opt_state).mu
    errs = sorted(((float((v.float() - want_mu[name].float()).abs().max()),
                    float(want_mu[name].float().abs().max()), name)
                   for name, v in state.opt_state.mu.items()), reverse=True)
    top = max(w for _, w, _ in errs)
    return {"loss": float(m["loss"]), "loss_ref": float(ref_m["loss"]),
            "loss_rel": metric_rel(m, ref_m, "loss"),
            "grad_norm_rel": metric_rel(m, ref_m, "grad_norm"),
            "bn_rel": bn, "params_rel": par, "mu_rel": errs[0][0] / top,
            "worst_mu": [(n, e / top, e / (w or 1.0))
                         for e, w, n in errs[:3]]}


def worst_reading(old, reading: dict) -> dict:
    """``reading``, or where ``old`` (an earlier seed's) is worse, its
    values: the largest errors and step time, the smallest control."""
    if old is None:
        return reading
    for k in ("loss_rel", "grad_norm_rel", "bn_rel", "params_rel", "mu_rel",
              "step_ms"):
        reading[k] = max(reading[k], old[k])
    if old["mu_rel"] >= reading["mu_rel"]:
        reading["worst_mu"] = old["worst_mu"]
    reading["control_loss_rel"] = min(reading["control_loss_rel"],
                                      old["control_loss_rel"])
    reading["seeds"] = old["seeds"] + 1
    return reading


def parallel_rank(out_dir: str, seeds: int = 1) -> None:
    """One of the two processes of phase 18b on card 0, joined over an
    explicitly chosen gloo group: the flagship latent step at b64 on a
    data 2 mesh, then on a model 2 mesh, against the one-process step on
    the same weights, batch and generator (``seeds`` of them: the worst
    reading is kept); writes its readings to ``out_dir/rank{r}.json``."""
    from blt_vqg_tpu_torch.core.distributed import initialize_distributed
    from blt_vqg_tpu_torch.parallel.sharding import place_state
    rank = int(os.environ["RANK"])
    initialize_distributed(device="cuda", backend="gloo", local_rank=0,
                           timeout_s=300)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    cfg = serve.flagship_config().replace(use_pallas_attention=True,
                                          attention_dropout=0.0)
    vocab = serve.FLAGSHIP_VOCAB
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    result = {"rank": rank, "backend": torch.distributed.get_backend()}
    for tag, shape, seed in [(t, sh, SEED + i) for t, sh in (
            ("data 2", (2, 1)), ("model 2", (1, 2))) for i in range(seeds)]:
        batch = make_batch(cfg, vocab, BATCH,
                           np.random.RandomState(seed + 18), device=dev)
        mesh = build_mesh(shape, ("data", "model"), device=dev)
        ref = create_train_state(cfg, IQ(cfg, vocab).to(dev), seed=seed)
        ref, ref_m = make_train_step(cfg, True)(
            ref, batch, torch.Generator(dev).manual_seed(seed + 1))
        state = place_state(create_train_state(
            cfg, IQ(cfg, vocab).to(dev), seed=seed), mesh)
        index, count = mesh.batch_coord()
        n = BATCH // count
        rows = {k: v[index * n:(index + 1) * n] for k, v in batch.items()}
        step = make_train_step(cfg, True, mesh)
        zero_flash_launches()
        with torch.profiler.profile(activities=acts) as prof:
            state, m = step(state, rows,
                            torch.Generator(dev).manual_seed(seed + 1))
            torch.cuda.synchronize()
        launches = flash_launches()
        fams = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                fam = kernel_family(evt.key, FLASH_STEP_KERNELS)
                fams[fam] = fams.get(fam, 0) + evt.count
        errs = state_errors(state, ref, m, ref_m)
        # the control: the one-process step with other dropout masks
        other = create_train_state(cfg, IQ(cfg, vocab).to(dev), seed=seed)
        _, other_m = make_train_step(cfg, True)(
            other, batch, torch.Generator(dev).manual_seed(seed + 99))
        control = metric_rel(m, other_m, "loss")
        del ref, other
        torch.cuda.empty_cache()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.distributed.barrier()
        ev[0].record()
        for i in range(PAR_TIMED_STEPS):
            state, _ = step(state, rows,
                            torch.Generator(dev).manual_seed(seed + 2 + i))
        ev[1].record()
        ev[1].synchronize()
        reading = {
            **errs, "control_loss_rel": control, "launches": launches,
            "profiled": {k: fams.get(k, 0) for k in FLASH_STEP_KERNELS},
            "step_ms": ev[0].elapsed_time(ev[1]) / PAR_TIMED_STEPS,
            "rows": n, "heads": state.model.decoder.layers[0].self_attn
            .num_heads, "seeds": 1}
        result[tag] = worst_reading(result.get(tag), reading)
        del state, step
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


def run_pair(args: list, root: str, tag: str, timeout: float = 600):
    """Starts this script twice with ``args`` as ranks 0 and 1 of a world
    of 2 on card 0, waits for both (killing both past ``timeout`` s) and
    returns (their ``root/rank{r}.json`` results, the wall seconds)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(_child_env(), RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(
                10.0, timeout - (time.perf_counter() - t0)))[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    failed = [f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
              for r, (p, text) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise AssertionError(f"[{tag}] " + "\n".join(failed))
    results = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, wall


def parallel_pair_phase(dev, card, log, root: str, seeds: int = 1) -> dict:
    """Phase 18b: two processes on the one card (gloo, which takes
    all-reduces of CUDA tensors; NCCL refuses two ranks on one GPU), each
    running :func:`parallel_rank`; the flash kernels must run in both
    ranks and the steps match the one-process step within
    ``PAR_LIMITS``."""
    results, wall = run_pair(["--parallel-rank", root, "--parallel-seeds",
                              str(seeds)], root, "18b")
    for tag in ("data 2", "model 2"):
        for res in results:
            got = res[tag]
            want = {"flash_attention_fwd": 24, "flash_attention_bwd_dkdv": 24,
                    "flash_attention_bwd_dq": 24}
            prof = got["profiled"]
            bad = {k: v for k, v in got["launches"].items() if v != want[k]}
            bad.update({k: prof.get(k, 0) for k in FLASH_MMA
                        if not PROFILE_MIN_SHARE * 24 <= prof.get(k, 0)
                        <= 24})
            bad.update({k: prof[k] for k in FLASH_FMA if prof.get(k)})
            over = {k: got[f"{k}_rel"] for k in PAR_LIMITS
                    if not got[f"{k}_rel"] <= PAR_LIMITS[k]}
            if not got["control_loss_rel"] > PAR_LIMITS["loss"]:
                over["control (must fail)"] = got["control_loss_rel"]
            if bad or over:
                raise AssertionError(f"[18b] {tag} rank {res['rank']}: "
                                     f"launches {bad}, over limits {over}")
            log(f"[18b] {card}: {tag} (backend {res['backend']}), rank "
                f"{res['rank']}, {got['rows']} rows, {got['heads']} heads a "
                f"rank: loss {got['loss']:.6g} against the one-process "
                f"{got['loss_ref']:.6g} (relative {got['loss_rel']:.3g}, "
                f"limit {PAR_LIMITS['loss']}), grad norm relative "
                f"{got['grad_norm_rel']:.3g} (limit "
                f"{PAR_LIMITS['grad_norm']}), batch-norm statistics "
                f"{got['bn_rel']:.3g}, updated parameters "
                f"{got['params_rel']:.3g} and first moments "
                f"{got['mu_rel']:.3g} (of each tensor's max; the moments' "
                f"of the largest moment) (limits "
                f"{PAR_LIMITS['bn']}, {PAR_LIMITS['params']}, "
                f"{PAR_LIMITS['mu']}; worst of {got['seeds']} seeds; largest "
                f"moment errors (name, of the largest moment, of its own "
                f"max): {got['worst_mu']}); control, the one-process step "
                f"with other dropout masks: loss relative "
                f"{got['control_loss_rel']:.3g} (fails, as it must); flash "
                f"launches {got['launches']}, by profiler "
                f"{ {k: prof.get(k, 0) for k in FLASH_MMA} }")
        times = ", ".join(f"{r[tag]['step_ms']:.1f}" for r in results)
        log(f"[18b] {card}: {tag} step time {times} ms "
            f"(ranks 0, 1; CUDA events, mean of {PAR_TIMED_STEPS} steps, the "
            f"slowest seed's): "
            f"two processes on one card over gloo, which is no measure of "
            f"data or tensor parallelism across cards")
    log(f"[18b] both ranks done in {wall:.1f} s (host clock)")
    return {tag: [r[tag] for r in results] for tag in ("data 2", "model 2")}


def parallel_phase(dev, card, log, seeds: int = 1) -> dict:
    """Phase 18: 18a then 18b, on their own synthetic data."""
    root = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, "data"))
        data = cli_data(os.path.join(root, "data"), log, tag="18")
        cli = parallel_cli_phase(dev, card, log, data, root)
        pair_dir = os.path.join(root, "pair")
        os.makedirs(pair_dir)
        pair = parallel_pair_phase(dev, card, log, pair_dir, seeds)
        log(f"[18] phase 18 in {time.perf_counter() - t0:.1f} s (host "
            f"clock)")
        return {"cli": cli, "pair": pair}
    finally:
        shutil.rmtree(root, ignore_errors=True)

# ---------------------------------------------------------------------------
# the seq ring and GPipe across processes (phase 19)

P2P_SEQ = 2           # the decoder's T 20 rings over 2 processes, C 10 a rank
# (what, B, ranks, chunk, causal, pads): rows 6a-6d on the process ring,
# at the training shape and at phase 12's long chunk (1,024), within phase
# 12's limits; and at chunk 2,048, where the kernels and the plain version
# are each held against the plain version in f32 (P2P_F32_CASE)
P2P_RING_CASES = (
    ("training: T 20 on seq 2, causal, target pads", BATCH, P2P_SEQ, 10,
     True, "tail"),
    ("long: T 2048 on seq 2, causal, 10% trailing pads", 2, P2P_SEQ, 1024,
     True, "long"))
P2P_F32_CASE = ("longer: T 4096 on seq 2, causal, 10% trailing pads", 2,
                P2P_SEQ, 2048, True, "long")
# the 2-process steps against the one-process step on the same weights,
# batch and generator (state_errors' measures), bf16 compute.  seq 2: the
# one-process step rings the same shards on a LocalRing.  pipe 2: each
# microbatch's products run over 32 rows, the one-process step's over 64.
# Readings over 3 seeds (NVIDIA H100 80GB HBM3, 700.00 W; both ranks
# alike), seq 2 / pipe 2: loss 0 / 0, grad norm 1.85e-5 / 9.18e-6,
# statistics 0 / 0, parameters 0 / 0, first moments 4.56e-3 / 4.32e-3 (the
# gradients of a tensor used by several products sum in another order);
# the one-process step with another generator reads 5.86e-4 / 1.04e-3 on
# the loss and must fail its limit.
P2P_LIMITS = {"loss": 5e-5, "grad_norm": 1e-4, "bn": 1e-4, "params": 1e-4,
              "mu": 0.02}
PIPE_LIMITS = dict(P2P_LIMITS)
# chunk 2,048: each output of the kernels within this factor of the plain
# version's own relative norm error against the plain version in f32
# (readings, ranks 0 / 1, kernels against plain: o 2.02e-3 / 2.26e-3
# against 2.04e-3 / 2.28e-3, dq 1.79e-3 / 1.67e-3 against the same to 3
# digits, dk and dv alike)
RING_F32_FACTOR = 1.1
P2P_TIMED_STEPS = 2
RING_P2P_KERNELS = RING_MMA + ("ring_land_kernel",)


def profiled_counts(prof, families) -> dict:
    """Launches a profile recorded of each of ``families``."""
    fams = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            fam = kernel_family(evt.key, families)
            fams[fam] = fams.get(fam, 0) + evt.count
    return {k: fams.get(k, 0) for k in families}


def p2p_step(cfg, ref_cfg, mesh, ref_mesh, vocab, seed, dev, families):
    """One flagship latent step on ``mesh`` (this rank's process group)
    against the one-process step of ``ref_cfg`` on ``ref_mesh``, same
    weights, batch and generator; the control: the one-process step with
    another generator.  Returns (the readings, the launch counts and the
    profiled ones of the step, its state and step function)."""
    from blt_vqg_tpu_torch.parallel.sharding import place_state
    batch = make_batch(cfg, vocab, BATCH, np.random.RandomState(seed + 19),
                       device=dev)
    ref = create_train_state(ref_cfg, IQ(ref_cfg, vocab, ref_mesh).to(dev),
                             seed=seed)
    ref, ref_m = make_train_step(ref_cfg, True)(
        ref, batch, torch.Generator(dev).manual_seed(seed + 1))
    state = place_state(create_train_state(
        cfg, IQ(cfg, vocab, mesh).to(dev), seed=seed), mesh)
    step = make_train_step(cfg, True, mesh)
    zero_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, m = step(state, batch,
                        torch.Generator(dev).manual_seed(seed + 1))
        torch.cuda.synchronize()
    launches = ring_counts()
    errs = state_errors(state, ref, m, ref_m)
    other = create_train_state(ref_cfg, IQ(ref_cfg, vocab, ref_mesh).to(dev),
                               seed=seed)
    _, other_m = make_train_step(ref_cfg, True)(
        other, batch, torch.Generator(dev).manual_seed(seed + 99))
    errs["control_loss_rel"] = metric_rel(m, other_m, "loss")
    del ref, other
    torch.cuda.empty_cache()
    return errs, launches, profiled_counts(prof, families), (state, step,
                                                             batch)


def timed_steps(state, step, batch, seed: int) -> float:
    """ms per step by CUDA events over P2P_TIMED_STEPS steps, both ranks
    started together."""
    dev = batch["images"].device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.distributed.barrier()
    ev[0].record()
    for i in range(P2P_TIMED_STEPS):
        state, _ = step(state, batch,
                        torch.Generator(dev).manual_seed(seed + 2 + i))
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / P2P_TIMED_STEPS


def p2p_rank(out_dir: str, seeds: int = 1, device="cuda") -> None:
    """One of the two processes of phase 19 on card 0 (gloo): (a) the
    ``seq`` 2 latent step against the one-process ``LocalRing`` step, then
    the ring functions on the process ring against their plain versions;
    (b) the ``pipe`` 2 latent step against the one-process step; ``seeds``
    weight and batch seeds (the worst reading is kept).  Writes its
    readings to ``out_dir/rank{r}.json``."""
    from blt_vqg_tpu_torch.core.distributed import initialize_distributed
    from blt_vqg_tpu_torch.parallel.mesh import Mesh
    rank = int(os.environ["RANK"])
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    initialize_distributed(device=dev.type, backend="gloo", local_rank=0,
                           timeout_s=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    vocab = serve.FLAGSHIP_VOCAB
    base = serve.flagship_config().replace(use_pallas_attention=True,
                                           attention_dropout=0.0)
    result = {"rank": rank, "backend": torch.distributed.get_backend()}
    # (a) the seq ring: each process one rank
    scfg = base.replace(sequence_parallel=True, ring_attention_impl="pallas")
    mesh = build_mesh((1, 1, P2P_SEQ), ("data", "model", "seq"), device=dev)
    ring = mesh.ring("seq")
    for i in range(seeds):
        hop0 = ring.hop_bytes
        errs, launches, prof, run = p2p_step(
            scfg, scfg, mesh, Mesh({"seq": P2P_SEQ}, dev), vocab, SEED + i,
            dev, RING_P2P_KERNELS + FLASH_STEP_KERNELS)
        hops = ring.hop_bytes - hop0
        reading = {**errs, "launches": launches, "profiled": prof,
                   "hop_bytes": hops, "step_ms": timed_steps(*run, SEED + i),
                   "ring": [type(ring).__name__, ring.rank, ring.n],
                   "seeds": 1}
        result["seq 2"] = worst_reading(result.get("seq 2"), reading)
        del run
        torch.cuda.empty_cache()
    rows = {}
    for case in P2P_RING_CASES + (P2P_F32_CASE,):
        what, b, n, c, causal, pad = case
        q, k, v, kv_pad, do = ring_inputs(dev, b, n, c, pad, SEED + 19)
        own = [x[:, ring.rank * c:(ring.rank + 1) * c][None].contiguous()
               for x in (q, k, v, kv_pad, do)]
        if case is P2P_F32_CASE:
            rows[what] = {"f32": ring_f32_errors(ring, *own, causal)}
            continue
        try:
            errs, *readings = check_ring_shards(ring, *own, causal, what)
        except AssertionError as e:
            rows[what] = {"error": str(e)}
            continue
        rows[what] = {"err": errs, **dict(zip(
            ("ulps", "norm", "ml", "bwd_ulps", "bwd_norm"), readings))}
    result["ring functions"] = rows
    # (b) GPipe: each process one stage, deterministic
    pcfg = base.replace(relu_dropout=0.0, pipeline_stages=2,
                        pipeline_microbatches=2)
    pmesh = build_mesh((2,), ("pipe",), device=dev)
    for i in range(seeds):
        errs, launches, prof, run = p2p_step(
            pcfg, pcfg.replace(pipeline_stages=1), pmesh, None, vocab,
            SEED + i, dev, FLASH_STEP_KERNELS)
        reading = {**errs, "launches": launches, "profiled": prof,
                   "step_ms": timed_steps(*run, SEED + i), "seeds": 1}
        result["pipe 2"] = worst_reading(result.get("pipe 2"), reading)
        del run
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


def p2p_want(rank: int, nl: int) -> tuple:
    """The launches a rank's latent step asks for: (seq 2, pipe 2).  seq:
    per decoder self-attention the ring forward launches once per step of
    the rank's plan with a live block and the backward a dK/dV and a dQ
    kernel there and one landing kernel; flash takes the context and
    posterior encoders and the cross-attentions.  pipe: flash takes the
    encoders whole and the stage's nl / 2 layers' self- and
    cross-attentions on each of the 2 microbatches."""
    live = sum(1 for entries in ra.ring_plan(P2P_SEQ, True, True, rank)
               if entries)
    flash = {name: 3 * nl for name in FLASH_KERNELS}
    seq = {name: 0 for name in RING_KERNELS} | flash | {
        "ring_attention_fwd_bidir_shard": nl * live,
        "ring_attention_bwd_bidir_shard": nl * (2 * live + 1)}
    seq_prof = {"ring_fwd_mma_kernel": nl * live,
                "ring_bwd_dkdv_mma_kernel": nl * live,
                "ring_bwd_dq_mma_kernel": nl * live,
                "ring_land_kernel": nl} | dict(zip(FLASH_MMA, [3 * nl] * 3))
    per = 2 * nl + (nl // 2) * 2 * 2
    pipe = {name: 0 for name in RING_KERNELS} | {
        name: per for name in FLASH_KERNELS}
    return (seq, seq_prof), (pipe, dict(zip(FLASH_MMA, [per] * 3)))


def p2p_phase(dev, card, log, seeds: int = 1) -> dict:
    """Phase 19: two processes on the one card (gloo; NCCL refuses two
    ranks on one GPU), each running :func:`p2p_rank`; the readings within
    the limits, the launches as the plans predict, the controls failing."""
    root = tempfile.mkdtemp(prefix="chip_smoke_p2p_")
    try:
        results, wall = run_pair(["--p2p-rank", root, "--p2p-seeds",
                                  str(seeds)], root, "19")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nl = serve.flagship_config().num_layers
    for res in results:
        r = res["rank"]
        for tag, limits, (want, want_prof) in zip(
                ("seq 2", "pipe 2"), (P2P_LIMITS, PIPE_LIMITS),
                p2p_want(r, nl)):
            got = res[tag]
            prof = got["profiled"]
            bad = {k: v for k, v in got["launches"].items() if v != want[k]}
            bad.update({k: prof.get(k, 0) for k, n in want_prof.items()
                        if not PROFILE_MIN_SHARE * n <= prof.get(k, 0) <= n})
            bad.update({k: prof[k] for k in FLASH_FMA if prof.get(k)})
            over = {k: got[f"{k}_rel"] for k in limits
                    if not got[f"{k}_rel"] <= limits[k]}
            if not got["control_loss_rel"] > limits["loss"]:
                over["control (must fail)"] = got["control_loss_rel"]
            extra = (f", ring {got['ring']}, hop bytes {got['hop_bytes']}"
                     if tag == "seq 2" else "")
            log(f"[19] {card}: {tag} (backend {res['backend']}), rank {r}: "
                f"loss {got['loss']:.6g} against the one-process "
                f"{got['loss_ref']:.6g} (relative {got['loss_rel']:.3g}), "
                f"grad norm relative {got['grad_norm_rel']:.3g}, batch-norm "
                f"statistics {got['bn_rel']:.3g}, updated parameters "
                f"{got['params_rel']:.3g}, first moments {got['mu_rel']:.3g}"
                f" (limits {limits}; worst of {got['seeds']} seeds; largest "
                f"moment errors {got['worst_mu']}); control, another "
                f"generator: loss relative {got['control_loss_rel']:.3g}; "
                f"launches {got['launches']}, by profiler {prof}{extra}; "
                f"step {got['step_ms']:.1f} ms (CUDA events, mean of "
                f"{P2P_TIMED_STEPS} steps, the slowest seed's)")
            if bad or over:
                raise AssertionError(f"[19] {tag} rank {r}: launches {bad}, "
                                     f"over limits {over}")
        for what, row in res["ring functions"].items():
            if "f32" in row:
                k, p = row["f32"]["kernel"], row["f32"]["plain"]
                log(f"[19] {card}: ring functions on the process ring, rank "
                    f"{r}, {what} (H 8, Dh 128), two-way, against the plain "
                    f"version in f32, relative norm errors: the kernels "
                    f"(bf16) {k}, the plain version (bf16) {p} (limit: the "
                    f"kernels' within {RING_F32_FACTOR}x the plain "
                    f"version's)")
                over = {n: (k[n], p[n]) for n in k
                        if not k[n] <= RING_F32_FACTOR * p[n]}
                if over:
                    raise AssertionError(f"[19] rank {r}, {what}: the "
                                         f"kernels round further from f32 "
                                         f"than the plain version: {over}")
                continue
            if "error" in row:
                raise AssertionError(f"[19] rank {r}: {row['error']}")
            log(f"[19] {card}: ring functions on the process ring, rank {r},"
                f" {what} (B per case, H 8, Dh 128): max err "
                f"{row['ulps']:.3g} bf16 ulps, relative norm error "
                f"{row['norm']:.3g}, m/l {row['ml']:.3g} (limits "
                f"{RING_MAX_ULPS}, {RING_REL_NORM}, {RING_ML_REL}); max abs "
                f"err: " + ", ".join(
                    f"{k.replace('ring_attention_', '')} {v:.3g}"
                    for k, v in row["err"].items()))
    log(f"[19] {card}: both ranks done in {wall:.1f} s (host clock); two "
        f"processes on one card over gloo, whose hops and all-reduces go "
        f"through the host: no measure of a ring or a pipeline across cards")
    return {"results": results, "wall_s": wall}


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
    parser.add_argument("--variant-seeds", type=int, default=1,
                        help="weight and batch seeds of phase 17's flash "
                        "against einsum comparisons (head dim 256, MoE)")
    parser.add_argument("--sp-seeds", type=int, default=1,
                        help="weight and batch seeds of the "
                        "sequence-parallel training comparison")
    parser.add_argument("--flash-times-only", action="store_true",
                        help="build, take phase 7's flash kernel times and "
                        "stop (no result line): to compare two trees' "
                        "kernels on one card, run in turns from each tree")
    parser.add_argument("--ring-times-only", action="store_true",
                        help="build, take phase 14's ring function times at "
                        "the training shape and stop (no result line): to "
                        "compare two trees' kernels on one card, run in "
                        "turns from each tree")
    parser.add_argument("--dh256-times-only", action="store_true",
                        help="build, take phase 17a's head-dim-256 kernel "
                        "times (the flash kernels at the training shapes and "
                        "the multi-tile shape, the ring functions at the "
                        "training and the long shape) and stop (no result "
                        "line); the --*-times-only options combine in one "
                        "process, in this order: flash, ring, dh256, decode, "
                        "int8")
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
    parser.add_argument("--train-cli-only", action="store_true",
                        help="build, run phase 15 (the train CLI) and stop "
                        "(no result line)")
    parser.add_argument("--variants-only", action="store_true",
                        help="build, run phase 17 (the model variants and "
                        "train-step options, head dim 256) and stop (no "
                        "result line)")
    parser.add_argument("--parallel-only", action="store_true",
                        help="build, run phase 18 (data and tensor "
                        "parallelism across processes) and stop (no result "
                        "line)")
    parser.add_argument("--parallel-rank", type=str, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--parallel-seeds", type=int, default=1,
                        help="weight and batch seeds of phase 18b's "
                        "two-process steps (more seeds take readings for "
                        "limits)")
    parser.add_argument("--p2p-only", action="store_true",
                        help="build, run phase 19 (the seq ring and GPipe "
                        "across two processes) and stop (no result line)")
    parser.add_argument("--p2p-rank", type=str, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--p2p-seeds", type=int, default=1,
                        help="weight and batch seeds of phase 19's "
                        "two-process steps (more seeds take readings for "
                        "limits)")
    parser.add_argument("--eval-cli-only", action="store_true",
                        help="build, run the 6-step train CLI run phase 16 "
                        "needs, then phase 16 (the evaluation and tune "
                        "CLIs), and stop (no result line)")
    opts = parser.parse_args(argv)
    if opts.parallel_rank is not None:
        # one rank of phase 18b, started by the phase itself
        parallel_rank(opts.parallel_rank, opts.parallel_seeds)
        return
    if opts.p2p_rank is not None:
        # one rank of phase 19, started by the phase itself
        p2p_rank(opts.p2p_rank, opts.p2p_seeds)
        return
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
    times = [fn for on, fn in (
        (opts.flash_times_only, lambda: flash_timings(dev, card, log)),
        (opts.ring_times_only, lambda: ring_case_times(
            dev, card, log, "training", RING_TRAIN_CASE)),
        (opts.dh256_times_only, lambda: dh256_times(dev, card, log)),
        (opts.decode_times_only, lambda: decode_times(dev, card, log)),
        (opts.int8_times_only, lambda: int8_times(dev, card, log))) if on]
    if times:
        for fn in times:
            fn()
        return
    if opts.train_cli_only:
        train_cli_phase(dev, card, log)
        return
    if opts.eval_cli_only:
        eval_cli_only(dev, card, log)
        return
    if opts.parallel_only:
        parallel_phase(dev, card, log, opts.parallel_seeds)
        return
    if opts.p2p_only:
        p2p_phase(dev, card, log, opts.p2p_seeds)
        return
    if opts.variants_only:
        mma_code(lib_path, report)
        variants_phase(dev, card, log, opts.variant_seeds)
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
    # ---- 15. the train CLI, then 16. the evaluation CLIs on its model
    train_cli_phase(dev, card, log, then=lambda data, model_dir:
                    eval_cli_phase(dev, card, log, data, model_dir))
    # ---- 17. the model variants and the train-step options
    dh_flash, dh_ring, dh_err = variants_phase(dev, card, log,
                                               opts.variant_seeds)
    # ---- 18. data and tensor parallelism across processes
    parallel_phase(dev, card, log, opts.parallel_seeds)
    # ---- 19. the seq ring and GPipe across processes
    p2p_phase(dev, card, log, opts.p2p_seeds)

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
        # head dim 256 (phase 17a): the 24 calls of a latent step at H 4
        row.update({f"dh256_{k}": dh_flash[name][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}, dh256_max_abs_err=dh_err[name])
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
        # head dim 256 (phase 17a): 6 calls at the training shape, H 4
        row.update({f"dh256_{k}": (dh_ring[name][k] if k == "bound_by"
                                   else 6 * dh_ring[name][k]) for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}, dh256_max_abs_err=dh_err[name])
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
