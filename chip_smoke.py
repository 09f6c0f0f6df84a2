"""Drives the PyTorch port's serving path on one CUDA card and checks the
hand-written kernels it runs.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; the last line is printed
only when every phase passed):

0. the card (``nvidia-smi`` name and power limit) and the versions;
1. builds the kernels from ``blt_vqg_tpu_torch/csrc`` (nvcc, first use);
2. holds each kernel against its plain PyTorch version at the flagship
   shapes in bf16, on the same CUDA tensors;
3. serves 3 request rounds of batch 64 through ``blt_vqg_tpu_torch.serve``
   at the flagship configuration (streaming stack, int8 fused head) with
   seed-made weights, checks the tokens and that each kernel launched 51
   times per round, and replays one round step by step against the plain
   versions;
4. times decode questions/s at batch 64 on the kernel path and on the
   port's plain decode path, and each kernel against its plain version.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import time

import numpy as np
import torch

from blt_vqg_tpu_torch import serve
from blt_vqg_tpu_torch.models.iq import IQ, PAD
from blt_vqg_tpu_torch.ops.kernels import _build, decode_head, decode_stream
from blt_vqg_tpu_torch.ops.layers import cast_to_compute_dtype_

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


def check_stack(got, want, what: str):
    """Raises unless the kernel's (x_out, k_new, v_new) are within the
    stated tolerances of the plain version's.  Returns (max |x_out err|,
    the worst max error in ulps and relative norm error of the three)."""
    ulps, norm = stack_errors(got, want)
    if not (ulps <= STACK_MAX_ULPS and norm <= STACK_REL_NORM):
        raise AssertionError(f"decode_stack_step {what}: max err {ulps:.3g} "
                             f"bf16 ulps, rel norm err {norm:.3g}")
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


# ---------------------------------------------------------------------------
def main():
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
                f"tie: all rows pick column {c1}")

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
            p = cuda_ms(lambda: decode_stream.decode_stack_step_ref(*args,
                                                                    **kw), 5)
            timings[("stack", quantized)] = (k, p)
            log(f"[4] {card}: decode_stack_step "
                f"{'int8' if quantized else 'bf16'} weights, b{BATCH} pos 25:"
                f" kernel {k * 1e3:.1f} us, plain {p * 1e3:.1f} us")
        hx = x_outs[0]
        for quantized in (True, False):
            h = head_args(model, quantized)
            k = cuda_ms(lambda: run_head(h, hx, kernel=True), 50)
            p = cuda_ms(lambda: run_head(h, hx, kernel=False), 50)
            timings[("head", quantized)] = (k, p)
            log(f"[4] {card}: head_argmax {'int8' if quantized else 'bf16'}"
                f" b{BATCH} V {h['w'].shape[1]}: kernel {k * 1e3:.1f} us, "
                f"plain {p * 1e3:.1f} us (weights L2-resident across "
                f"repeats)")

    # main-path forms: bf16 stack weights, int8 head
    stack_k, stack_p = timings[("stack", False)]
    head_k, head_p = timings[("head", True)]
    kernels = [
        {"name": "decode_stack_step", "route": "cuda", "source": STACK_SRC,
         "replaces": STACK_TPU, "launches": launches["decode_stack_step"],
         "max_abs_err": stack_err, "ms": stack_k, "plain_ms": stack_p},
        {"name": "head_argmax", "route": "cuda", "source": HEAD_SRC,
         "replaces": HEAD_TPU, "launches": launches["head_argmax"],
         "max_abs_err": head_err, "ms": head_k, "plain_ms": head_p},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
