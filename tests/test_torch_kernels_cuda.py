"""The CUDA kernels of the PyTorch port against their plain versions, on
the card.

These tests need a CUDA card and ``nvcc`` (the kernels are built at first
use) and skip without one.  They import no jax, so they also run on a
machine without it; there run them without the repository's conftest,
which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes are small and deliberately ragged (rows beyond one 64-row tile,
widths that are not multiples of a tile or of a 16-byte load, a vocab that
ends inside a tile), in f32 and bf16 activations, with bf16/f32 or int8
weights.  Tolerances: f32 differs from the plain version only in the order
of f32 sums (1e-4 relative to the output's scale); bf16 rounds every
LayerNorm output and residual to bf16 after sums taken in another order,
so one-ulp flips propagate (2e-2 relative max error, 1e-2 relative norm
error).  A head token must have a plain logit within 1e-4 (f32) or 1e-3
(bf16) times max|logit| of the row maximum.  Flash attention (forward o,
m, l and backward dq, dk, dv): f32 within 1e-4 of the output's scale (sum
order and the exp implementation); bf16 rounds p before the PV product and
every output, so a flipped rounding moves an output by one ulp (2e-2
relative max error, 1e-2 relative norm error); the bf16 tensor-core
kernels are held at the edges of their tiling the same way, with exactly
one launch per call, and the bf16 forward alone at chip_smoke.py's limits
(2 ulps of max|plain|, 2e-3 relative norm error, m and l 4e-7).  The
per-layer decode kernels (``self_attn_step``, ``cross_ffn_step``: outputs
and the written cache rows) and ``int8_matmul`` take the stack's limits:
f32 up to the order of f32 sums, bf16 one-ulp flips of rounded outputs and
residuals.
The decode stack step and ``cross_ffn_step`` run their launch sequences
(programmatic dependent launches): 12 kernels a layer and one (stack) or
9 (cross/FFN) and nothing else, by profiler (which may drop a record, never
add one); the stack also at the flagship's widths at b64, b128 and b512
with bf16 and int8 weights, and the per-layer steps at the flagship's
widths at b64 and b256.
The four ring-attention functions (o, m, l, dq, dk, dv, one-way and
two-way, on rings of 2, 3 and 4 ranks with ragged chunks) take the flash
limits; their dead rows attend uniformly and must not come out zero.  The
forward and the backward functions are also held alone at chunks of 1 to
1,024 rows and head dims 64, 80, 128, 136, 200 and 256, with their launches
per call (the flash kernels also at head dims 136, 200 and 256);
the backward's cases include dead rows at a 130-row chunk, whose dv needs
the query tiles before a causal key tile.
``int8_matmul`` runs its bf16 calls whose strides TMA can load on one
``int8_wgmma_kernel`` launch (checked by profiler at the flagship shapes;
a ragged N takes the split-K product's two kernels), also at ragged M and
N edges.  Repeated calls on the same inputs (the bf16 ``self_attn_step``
and ``head_argmax`` on the cluster product, ``int8_matmul``, the bf16
forwards of flash and ring attention above head dim 128) must give the
same bits each time: every kernel sums in a fixed order, so a difference
is a race.
"""

import numpy as np
import pytest
import torch

from blt_vqg_tpu_torch.ops.kernels import decode_head as tdh
from blt_vqg_tpu_torch.ops.kernels import decode_layer as tdl
from blt_vqg_tpu_torch.ops.kernels import decode_stream as tds
from blt_vqg_tpu_torch.ops.kernels import flash_attention as tfa
from blt_vqg_tpu_torch.ops.kernels import int8_matmul as tim
from blt_vqg_tpu_torch.ops.kernels import ring_attention as tra
from blt_vqg_tpu_torch.ops.ring_attention import ring_attention
from blt_vqg_tpu_torch.parallel import build_mesh

pytestmark = pytest.mark.cuda

KINDS = ("wqkv", "wout", "wqc", "woc", "w1", "w2")
STACK_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
HEAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _stack_inputs(dev, dt, quant, b, h, dh, f, nl, lmax, seed):
    hc, fc = tds.pick_stages(h, f)
    d, hpc, fch = h * dh, h // hc, f // fc
    tc = 3
    r = np.random.RandomState(seed)

    def n(*s, sc=1.0):
        return torch.from_numpy((r.randn(*s) * sc).astype(np.float32))

    w = {"wqkv": n(nl, h, d, 3 * dh, sc=d ** -0.5),
         "wout": n(nl, h, dh, d, sc=d ** -0.5),
         "wqc": n(nl, hc, d, hpc * dh, sc=d ** -0.5),
         "woc": n(nl, hc, hpc * dh, d, sc=d ** -0.5),
         "w1": n(nl, fc, d, fch, sc=d ** -0.5),
         "w2": n(nl, fc, fch, d, sc=f ** -0.5)}
    scales = [None] * 6
    for i, k in enumerate(KINDS):
        if quant in ("all", k):
            w[k], scales[i] = tds.quantize_stack(w[k])
        else:
            w[k] = w[k].to(dt)
    lns = torch.stack([1.0 + n(nl, d, sc=0.1) if i % 2 == 0
                       else n(nl, d, sc=0.1) for i in range(6)], dim=1)
    smask = torch.zeros((tc, b), dtype=torch.int32)
    smask[2, ::3] = 1
    kp = torch.from_numpy((r.rand(lmax, b) < 0.3).astype(np.float32))
    kp[0] = 1.0
    args = [n(b, d, sc=2.0).to(dt), lns, w["wqkv"], w["wout"],
            n(nl, h, lmax, b, dh).to(dt), n(nl, h, lmax, b, dh).to(dt),
            w["wqc"], w["woc"], n(nl, hc, tc, b, hpc * dh).to(dt),
            n(nl, hc, tc, b, hpc * dh).to(dt), smask, w["w1"],
            n(nl, fc, 1, fch, sc=0.1), w["w2"], n(nl, 1, d, sc=0.1)]
    args = [a.to(dev).contiguous() for a in args]
    kw = dict(num_heads=h, cross_stages=hc, ffn_stages=fc,
              weight_scales=(None if quant == "none" else
                             tuple(None if s is None else s.to(dev)
                                   for s in scales)))
    return args, kw, kp.to(dev)


# (batch, heads, head_dim, ffn, layers, lmax, pos, key_pad, weights)
STACK_CASES = [
    (3, 4, 16, 72, 2, 7, 0, False, "none"),
    (3, 4, 16, 72, 2, 7, 3, True, "all"),
    (70, 2, 40, 64, 1, 5, 4, True, "none"),
    (70, 2, 40, 64, 1, 5, 2, False, "w2"),
    (8, 8, 128, 2048, 1, 9, 5, True, "all"),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", STACK_CASES,
                         ids=[f"case{i}" for i in range(len(STACK_CASES))])
def test_decode_stack_step_kernel(dev, dt, case):
    b, h, dh, f, nl, lmax, pos, with_kp, quant = case
    args, kw, kp = _stack_inputs(dev, dt, quant, b, h, dh, f, nl, lmax,
                                 seed=pos + 11)
    if with_kp:
        kw.update(key_pad=kp, key_pad_cur=kp[pos:pos + 1].contiguous())
    x, rest = args[0], args[1:]
    before = tds.decode_stack_step.launches
    got = tds.decode_stack_step(x, pos, *rest, **kw)
    torch.cuda.synchronize()
    assert tds.decode_stack_step.launches == before + 1
    want = tds.decode_stack_step_ref(x, pos, *rest, **kw)
    rel_max_tol, rel_norm_tol = STACK_TOL[dt]
    for name, g, wv in zip(("x_out", "k_new", "v_new"), got, want):
        assert g.shape == wv.shape and g.dtype == wv.dtype, name
        g, wv = g.float(), wv.float()
        assert bool(torch.isfinite(g).all()), name
        err = (g - wv).abs()
        assert float(err.max() / wv.abs().max()) <= rel_max_tol, name
        assert float(err.norm() / wv.norm()) <= rel_norm_tol, name


def _kernels_per_call(fn, calls: int = 4) -> dict:
    """{device kernel name: records per call} of ``calls`` calls of ``fn``
    by profiler, after a warm-up call (taken again, up to twice, if the
    profiler recorded nothing)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.count / calls for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if out:
            break
    return out


def _runs_sequence(fn, want: dict) -> None:
    """Each call of ``fn`` runs the kernels ``want`` ({name: launches per
    call}, matched as whole identifiers) and nothing else; the profiler may
    drop records, never add them."""
    import re

    got = {}
    for name, n in _kernels_per_call(fn).items():
        fam = next((k for k in want
                    if re.search(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])",
                                 name)), name)
        got[fam] = got.get(fam, 0.0) + n
    assert got, "the profiler recorded no device kernel"
    for fam, n in got.items():
        assert n <= want.get(fam, 0) + 1e-6, got


def _stack_kernels(layers: int) -> dict:
    """A stack call's kernels: per layer 6 products' partials, 2 attention
    kernels (summing their q, k, v from the partials), 3 residual epilogues
    with the LayerNorm after them (the last layer's last without) and the
    FFN-in epilogue; one LayerNorm first."""
    return {"layernorm_kernel": 1, "gemm_partial_kernel": 6 * layers,
            "self_attn_kernel": layers, "cross_attn_kernel": layers,
            "residual_ln_kernel": 3 * layers - 1,
            "gemm_epilogue_kernel": layers + 1}


@pytest.mark.parametrize("case", STACK_CASES,
                         ids=[f"case{i}" for i in range(len(STACK_CASES))])
def test_decode_stack_step_launch_sequence(dev, case):
    b, h, dh, f, nl, lmax, pos, with_kp, quant = case
    args, kw, kp = _stack_inputs(dev, torch.bfloat16, quant, b, h, dh, f, nl,
                                 lmax, seed=pos + 11)
    if with_kp:
        kw.update(key_pad=kp, key_pad_cur=kp[pos:pos + 1].contiguous())
    _runs_sequence(
        lambda: tds.decode_stack_step(args[0], pos, *args[1:], **kw),
        _stack_kernels(nl))


# the flagship's widths (2 of its 6 layers) at b64, b128 and b512, bf16
# activations, bf16 or int8 weights: (batch, heads, head_dim, ffn, layers,
# lmax, pos, key_pad, weights)
STACK_FLAGSHIP = [(b, 8, 128, 2048, 2, 51, 25, True, quant)
                  for b in (64, 128, 512) for quant in ("none", "all")]


@pytest.mark.parametrize("case", STACK_FLAGSHIP,
                         ids=[f"b{c[0]}-{c[-1]}" for c in STACK_FLAGSHIP])
def test_decode_stack_step_flagship_kernel(dev, case):
    b, h, dh, f, nl, lmax, pos, _, quant = case
    args, kw, kp = _stack_inputs(dev, torch.bfloat16, quant, b, h, dh, f, nl,
                                 lmax, seed=b)
    kw.update(key_pad=kp, key_pad_cur=kp[pos:pos + 1].contiguous())
    x, rest = args[0], args[1:]
    got = tds.decode_stack_step(x, pos, *rest, **kw)
    want = tds.decode_stack_step_ref(x, pos, *rest, **kw)
    rel_max_tol, rel_norm_tol = STACK_TOL[torch.bfloat16]
    for name, g, wv in zip(("x_out", "k_new", "v_new"), got, want):
        g, wv = g.float(), wv.float()
        assert bool(torch.isfinite(g).all()), name
        err = (g - wv).abs()
        assert float(err.max() / wv.abs().max()) <= rel_max_tol, name
        assert float(err.norm() / wv.norm()) <= rel_norm_tol, name
    _runs_sequence(lambda: tds.decode_stack_step(x, pos, *rest, **kw),
                   _stack_kernels(nl))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,v,quantized", [(3, 40, 300, False),
                                             (3, 40, 300, True),
                                             (70, 96, 1000, True),
                                             (64, 1024, 12000, True)])
def test_head_argmax_kernel(dev, dt, b, d, v, quantized):
    r = np.random.RandomState(v + b)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    x = t(r.randn(b, d) * 3.0).to(dt)
    ln_s, ln_b = t(1.0 + 0.1 * r.randn(d)), t(0.1 * r.randn(d))
    w, bias = t(r.randn(d, v) * d ** -0.5), t(r.randn(v))
    chunk = tdh.head_chunk(v)
    scales = None
    if quantized:
        w, scales = tds.quantize_stack(w)
        w, bias = tdh.pad_head(w, bias, chunk)
        scales = torch.nn.functional.pad(
            scales, (0, w.shape[1] - scales.shape[1]), value=1.0)
    else:
        w, bias = tdh.pad_head(w.to(dt), bias, chunk)
    x, ln_s, ln_b, w, bias = (a.to(dev).contiguous()
                              for a in (x, ln_s, ln_b, w, bias))
    if scales is not None:
        scales = scales.to(dev).contiguous()
    before = tdh.head_argmax.launches
    tok = tdh.head_argmax(x, ln_s, ln_b, w, bias, chunk=chunk, scales=scales)
    torch.cuda.synchronize()
    assert tdh.head_argmax.launches == before + 1
    assert tok.shape == (b,) and tok.dtype == torch.int32
    assert bool(((tok >= 0) & (tok < v)).all())
    logits = tdh.head_logits_ref(x, ln_s, ln_b, w, bias, scales)
    short = logits.max(-1).values - logits.gather(1, tok.long()[:, None])[:, 0]
    assert float(short.max()) <= HEAD_TOL[dt] * float(logits.abs().max())


def _head_inputs(dev, dt, b, d, v, quantized, seed):
    r = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    x = t(r.randn(b, d) * 3.0).to(dt)
    ln_s, ln_b = t(1.0 + 0.1 * r.randn(d)), t(0.1 * r.randn(d))
    w, bias = t(r.randn(d, v) * d ** -0.5), t(r.randn(v))
    chunk = tdh.head_chunk(v)
    scales = None
    if quantized:
        w, scales = tds.quantize_stack(w)
        w, bias = tdh.pad_head(w, bias, chunk)
        scales = torch.nn.functional.pad(
            scales, (0, w.shape[1] - scales.shape[1]), value=1.0).to(dev)
    else:
        w, bias = tdh.pad_head(w.to(dt), bias, chunk)
    return ([a.to(dev).contiguous() for a in (x, ln_s, ln_b, w, bias)],
            scales, chunk)


# (batch, dim, vocab, int8 weights) of the bf16 head on the cluster
# product: ragged vocabs, B 1, 3, 65 and 256 (four row tiles), depths of
# one rank (40, 96), two (320) and four (1,024)
HEAD_CLUSTER_CASES = [
    (1, 1024, 1000, True), (1, 320, 777, False), (3, 96, 300, False),
    (3, 1024, 12000, True), (65, 1024, 12000, True), (65, 256, 777, False),
    (256, 1024, 12000, True), (256, 40, 300, False),
]


@pytest.mark.parametrize("case", HEAD_CLUSTER_CASES,
                         ids=[f"b{c[0]}-d{c[1]}-v{c[2]}-{'int8' if c[3] else 'bf16'}"
                              for c in HEAD_CLUSTER_CASES])
def test_head_argmax_cluster_kernel(dev, case):
    """The bf16 head (3 launches, no logits stored): every token's plain
    logit within the limit of the row maximum; a planted three-way tie
    (two columns of one vocab tile, on two ranks, and one of another tile)
    picks the lowest column."""
    b, d, v, quantized = case
    (x, ln_s, ln_b, w, bias), scales, chunk = _head_inputs(
        dev, torch.bfloat16, b, d, v, quantized, seed=v + b)
    before = tdh.head_argmax.launches
    tok = tdh.head_argmax(x, ln_s, ln_b, w, bias, chunk=chunk, scales=scales)
    torch.cuda.synchronize()
    assert tdh.head_argmax.launches == before + 1
    assert tok.shape == (b,) and bool(((tok >= 0) & (tok < v)).all())
    logits = tdh.head_logits_ref(x, ln_s, ln_b, w, bias, scales)
    short = logits.max(-1).values - logits.gather(1, tok.long()[:, None])[:, 0]
    assert float(short.max()) <= HEAD_TOL[torch.bfloat16] * float(
        logits.abs().max())
    c1, c2, c3 = 2, 61, min(v - 1, 200)
    w, bias = w.clone(), bias.clone()
    for c in (c2, c3):
        w[:, c] = w[:, c1]
        bias[c] = 1e4
    bias[c1] = 1e4
    if scales is not None:
        scales = scales.clone()
        scales[0, c2] = scales[0, c3] = scales[0, c1]
    tok = tdh.head_argmax(x, ln_s, ln_b, w, bias, chunk=chunk, scales=scales)
    assert bool((tok == c1).all()), sorted(set(tok.tolist()))
    _runs_sequence(lambda: tdh.head_argmax(x, ln_s, ln_b, w, bias,
                                           chunk=chunk, scales=scales),
                   tdh.head_kernels(True))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16w", "int8w"])
def test_head_argmax_f32_launch_sequence(dev, quantized):
    """f32 activations keep the split-K chain: 4 kernels a call."""
    (x, ln_s, ln_b, w, bias), scales, chunk = _head_inputs(
        dev, torch.float32, 70, 96, 1000, quantized, seed=7)
    _runs_sequence(lambda: tdh.head_argmax(x, ln_s, ln_b, w, bias,
                                           chunk=chunk, scales=scales),
                   tdh.head_kernels(False))


# (batch, tq, tk, heads, head_dim, causal, pad): the training shapes, a
# ragged multi-tile pair, a causal multi-tile square, and "dead" rows (every
# key of batch row 1 masked) that must come out zero with zero gradients;
# then the edges of the bf16 backward's tiling: owned lengths at 1, 16, 17,
# 32 and 64 rows and past them (1, 2 or 4 warps per (b, h)), walked lengths
# of one tile and of several (a second stage, causal tiles skipped), Tq
# above and below Tk, head dims 8, 40, 80 and 128 (padded to 16), and B*H
# of 3, which leaves groups of the last block idle; then head dims 136 and
# 256, whose blocks split the accumulators' columns in two halves (the
# reference tune space's hidden 1024 over 4 heads), at training lengths,
# at several key tiles with dead rows, and ragged
FLASH_CASES = [
    (4, 20, 20, 8, 128, True, "tail"),
    (4, 20, 3, 8, 128, False, "tail"),
    (3, 130, 77, 2, 40, False, "random"),
    (2, 200, 200, 2, 8, True, "random"),
    (3, 5, 11, 2, 16, False, "dead"),
    (3, 1, 1, 1, 8, False, "tail"),
    (2, 3, 3, 8, 128, False, "tail"),
    (2, 16, 16, 4, 40, True, "random"),
    (3, 17, 17, 1, 80, False, "dead"),
    (4, 21, 21, 8, 128, False, "tail"),
    (3, 20, 3, 1, 40, True, "dead"),
    (3, 3, 20, 1, 80, False, "random"),
    (3, 33, 65, 2, 80, True, "random"),
    (2, 64, 64, 4, 128, False, "dead"),
    (3, 65, 130, 1, 8, True, "random"),
    (4, 21, 21, 4, 256, False, "tail"),
    (4, 20, 20, 4, 256, True, "tail"),
    (3, 70, 130, 2, 256, True, "dead"),
    (3, 33, 65, 2, 136, True, "random"),
]


def _flash_inputs(dev, dt, case, seed):
    b, tq, tk, h, d, causal, pad = case
    r = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32))
    q = (t(b, tq, h, d) * d ** -0.5).to(dt)
    k, v, do = t(b, tk, h, d).to(dt), t(b, tk, h, d).to(dt), t(b, tq, h, d).to(dt)
    if pad == "tail":
        lengths = r.randint(1, tk + 1, b)
        kv_pad = np.arange(tk)[None, :] >= lengths[:, None]
    else:
        kv_pad = r.rand(b, tk) < 0.3
        kv_pad[:, 0] = False
        if pad == "dead":
            kv_pad[1] = True
    kv_pad = torch.from_numpy(kv_pad)
    return [x.to(dev).contiguous() for x in (q, k, v, kv_pad, do)] + [causal]


def _close(got, want, dt, name):
    rel_max_tol, rel_norm_tol = STACK_TOL[dt]
    assert got.shape == want.shape and got.dtype == want.dtype, name
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all()), name
    err = (g - w).abs()
    scale = float(w.abs().max())
    assert float(err.max()) <= rel_max_tol * max(scale, 1e-30), name
    assert float(err.norm()) <= rel_norm_tol * max(float(w.norm()), 1e-30), name


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"case{i}" for i in range(len(FLASH_CASES))])
def test_flash_attention_kernels(dev, dt, case):
    q, k, v, kv_pad, do, causal = _flash_inputs(dev, dt, case, seed=len(case))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dkdv.launches,
              tfa.flash_attention_bwd_dq.launches)
    got = tfa.flash_attention_fwd(q, k, v, kv_pad, causal)
    want = tfa.flash_attention_fwd_ref(q, k, v, kv_pad, causal)
    for name, g, w in zip(("o", "m", "l"), got, want):
        _close(g, w, dt, name)
    o, m, l = want
    grads = tfa.flash_attention_bwd(q, k, v, kv_pad, o, m, l, do, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkdv.launches,
            tfa.flash_attention_bwd_dq.launches) == tuple(
                n + 1 for n in before)
    ref = tfa.flash_attention_bwd_ref(q, k, v, kv_pad, o, m, l, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), grads, ref):
        if k.shape[1] == 1 and name != "dv":
            # one key: the softmax is constant, so dq and dk are zero but
            # for the rounding of dp - delta, and both versions read noise;
            # hold the kernel's to the scale of the terms that cancel
            other = k if name == "dq" else q
            terms = float(do.float().abs().max() * v.float().abs().max()
                          * other.float().abs().max())
            assert float(g.float().abs().max()) <= STACK_TOL[dt][0] * terms
        else:
            _close(g, w, dt, name)
    if case[-1] == "dead":
        assert bool((got[0][1] == 0).all()) and bool((grads[0][1] == 0).all())
        assert bool((grads[1][1] == 0).all()) and bool((grads[2][1] == 0).all())


# the bf16 forward (flash_fwd_mma_kernel) alone, at chip_smoke.py's limits:
# o within 2 bf16 ulps of max|plain| and 2e-3 relative norm error, m and l
# on live rows within 4e-7 relative.  (batch, tq, tk, heads, head_dim,
# causal, pad): the four training shapes; 16 queries against 1,024 keys
# (two stages, 16-key tiles walked twice: the max, then the online pass);
# one key; head dims 8 and 80 (causal 130 x 70: blocks of one and of two
# key tiles); a dead batch row; head dim 256 at a training shape and at
# 1,024 keys; then the paired-warp forward above head dim 128 (each 16 rows
# a pair of warps, one for each half of o's columns): the four training
# shapes at B 64, H 4, Dh 256, a causal multi-tile shape with scattered
# pads, dead batch rows, and head dims 136 and 200, whose halves split off a
# 128-column boundary (80 + 64, 112 + 96).  Those cases also repeat the call
# 50 times and must get the same bits (the pair exchanges its row maxima
# and p through shared memory: a difference is a race)
FWD_MAX_ULPS, FWD_REL_NORM, FWD_ML_REL = 2.0, 2e-3, 4e-7
FWD_CASES = [
    (64, 3, 3, 8, 128, False, "tail"),
    (64, 21, 21, 8, 128, False, "tail"),
    (64, 20, 20, 8, 128, True, "tail"),
    (64, 20, 3, 8, 128, False, "tail"),
    (8, 16, 1024, 8, 128, False, "tail"),
    (16, 20, 1, 8, 128, False, "dead"),
    (5, 130, 70, 3, 8, True, "random"),
    (5, 70, 37, 3, 80, False, "dead"),
    (64, 21, 21, 4, 256, False, "tail"),
    (8, 16, 1024, 4, 256, False, "tail"),
    (64, 3, 3, 4, 256, False, "tail"),
    (64, 20, 20, 4, 256, True, "tail"),
    (64, 20, 3, 4, 256, False, "tail"),
    (8, 512, 512, 4, 256, True, "random"),
    (16, 20, 20, 4, 256, False, "dead"),
    (5, 70, 37, 3, 136, False, "dead"),
    (6, 33, 65, 2, 136, True, "random"),
    (4, 21, 21, 4, 200, False, "tail"),
    (3, 130, 130, 2, 200, True, "random"),
]


@pytest.mark.parametrize("case", FWD_CASES,
                         ids=[f"case{i}" for i in range(len(FWD_CASES))])
def test_flash_forward_mma_kernel(dev, case):
    q, k, v, kv_pad, _, causal = _flash_inputs(dev, torch.bfloat16, case,
                                               seed=len(case) + case[2])
    before = tfa.flash_attention_fwd.launches
    o, m, l = tfa.flash_attention_fwd(q, k, v, kv_pad, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    want_o, want_m, want_l = tfa.flash_attention_fwd_ref(q, k, v, kv_pad,
                                                         causal)
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all())
    err = (o.float() - want_o.float()).abs()
    top = float(want_o.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float(err.max()) <= FWD_MAX_ULPS * ulp
    assert float(err.norm()) <= FWD_REL_NORM * float(want_o.float().norm())
    live = want_m > 0.5 * tfa.NEG_INF
    for got, want in ((m, want_m), (l, want_l)):
        assert float((got[live] - want[live]).abs().max()) <= (
            FWD_ML_REL * float(want[live].abs().max()))
    assert bool((m[~live] <= 0.5 * tfa.NEG_INF).all())
    assert bool((l[~live] == 1).all())
    if case[-1] == "dead":
        assert bool((o[1] == 0).all())
    if case[4] > 128:
        _repeat_bit_equal(lambda: tfa.flash_attention_fwd(q, k, v, kv_pad,
                                                          causal))


def test_flash_attention_autograd(dev):
    """The autograd Function on CUDA tensors runs the kernels both ways."""
    q, k, v, kv_pad, do, causal = _flash_inputs(
        dev, torch.bfloat16, FLASH_CASES[0], seed=3)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    before = tfa.flash_attention_bwd_dq.launches
    out = tfa.flash_attention(q, k, v, kv_pad, causal)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    assert tfa.flash_attention_bwd_dq.launches == before + 1
    with torch.no_grad():
        o, m, l = tfa.flash_attention_fwd_ref(q, k, v, kv_pad, causal)
        ref = tfa.flash_attention_bwd_ref(q, k, v, kv_pad, o, m, l, do,
                                          causal)
    _close(out.detach(), o, torch.bfloat16, "o")
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _close(g, w, torch.bfloat16, name)


# ---------------------------------------------------------------------------
# the per-layer decode step and the W8A16 product

# (batch, heads, head_dim, ffn, lmax, pos, key_pad): batches that are not
# multiples of 16 or of a 64-row tile, the first and the last cache row
LAYER_CASES = [
    (3, 4, 16, 72, 7, 0, False),
    (3, 4, 16, 72, 7, 6, True),
    (70, 2, 40, 64, 5, 4, True),
    (70, 2, 40, 64, 5, 0, False),
    (20, 8, 128, 2048, 9, 8, True),
]


def _layer_inputs(dev, dt, case, seed):
    b, h, dh, f, lmax, pos, with_kp = case
    d, tc = h * dh, 3
    r = np.random.RandomState(seed)

    def n(*s, sc=1.0):
        return torch.from_numpy((r.randn(*s) * sc).astype(np.float32))

    x = n(b, d, sc=2.0).to(dt)
    ln = [1.0 + n(d, sc=0.1), n(d, sc=0.1)]
    self_args = [x, *ln, n(h, d, 3 * dh, sc=d ** -0.5).to(dt),
                 n(h, dh, d, sc=d ** -0.5).to(dt),
                 n(h, lmax, b, dh).to(dt), n(h, lmax, b, dh).to(dt)]
    cross_args = [x, 1.0 + n(d, sc=0.1), n(d, sc=0.1),
                  n(d, d, sc=d ** -0.5).to(dt), n(b, tc, h, dh).to(dt),
                  n(b, tc, h, dh).to(dt), None, n(d, d, sc=d ** -0.5).to(dt),
                  1.0 + n(d, sc=0.1), n(d, sc=0.1), n(d, f, sc=d ** -0.5).to(dt),
                  n(f, sc=0.1), n(f, d, sc=f ** -0.5).to(dt), n(d, sc=0.1)]
    self_args = [a.to(dev).contiguous() for a in self_args]
    cross_args = [a if a is None else a.to(dev).contiguous()
                  for a in cross_args]
    # the source mask: a padded column, and batch row 1 fully masked
    src_pad = torch.zeros((b, tc), dtype=torch.bool)
    src_pad[:, tc - 1] = True
    src_pad[1 % b] = True
    cross_args[6] = src_pad.to(dev)
    kp = None
    if with_kp:   # [B, L] marks at rows <= pos, passed as its [L, B] view
        marks = torch.from_numpy(r.rand(b, lmax) < 0.3)
        marks[:, pos + 1:] = False
        marks[0, :pos + 1] = True
        kp = marks.float().to(dev).T
    return self_args, cross_args, kp


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"case{i}" for i in range(len(LAYER_CASES))])
def test_self_attn_step_kernel(dev, dt, case):
    pos, h = case[5], case[1]
    args, _, kp = _layer_inputs(dev, dt, case, seed=pos + 31)
    x, ls, lb, wqkv, wout, ck, cv = args
    before = tdl.self_attn_step.launches
    got, gk, gv = tdl.self_attn_step(x, ls, lb, wqkv, wout, ck.clone(),
                                     cv.clone(), pos, h, key_pad=kp)
    torch.cuda.synchronize()
    assert tdl.self_attn_step.launches == before + 1
    want, wk, wv = tdl.self_attn_step_ref(x, ls, lb, wqkv, wout, ck.clone(),
                                          cv.clone(), pos, h, key_pad=kp)
    _close(got, want, dt, "out")
    for name, g, w, orig in (("k", gk, wk, ck), ("v", gv, wv, cv)):
        others = torch.arange(ck.shape[1], device=dev) != pos
        assert torch.equal(g[:, others], orig[:, others]), name
        _close(g[:, pos], w[:, pos], dt, name)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"case{i}" for i in range(len(LAYER_CASES))])
def test_cross_ffn_step_kernel(dev, dt, case):
    _, args, _ = _layer_inputs(dev, dt, case, seed=case[0] + 41)
    h = case[1]
    before = tdl.cross_ffn_step.launches
    got = tdl.cross_ffn_step(*args, h)
    torch.cuda.synchronize()
    assert tdl.cross_ffn_step.launches == before + 1
    _close(got, tdl.cross_ffn_step_ref(*args, h), dt, "out")
    # a broadcast source mask (stride 0 over the batch) reads the same
    row = args[6][0].clone()
    bcast = list(args)
    bcast[6] = row[None].expand(args[0].shape[0], -1)
    _close(tdl.cross_ffn_step(*bcast, h),
               tdl.cross_ffn_step_ref(*bcast, h), dt, "broadcast mask")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LAYER_CASES + [
    (64, 8, 128, 2048, 51, 25, False), (256, 8, 128, 2048, 51, 25, False)],
    ids=[f"case{i}" for i in range(len(LAYER_CASES))] + ["b64", "b256"])
def test_per_layer_steps_launch_sequence(dev, dt, case):
    """self_attn_step runs 4 kernels a call in bf16 and 6 in f32,
    cross_ffn_step 9; the flagship's widths within the limits."""
    self_args, args, kp = _layer_inputs(dev, dt, case, seed=case[0] + 41)
    h, pos = case[1], case[5]
    if case[0] >= 64:
        _close(tdl.cross_ffn_step(*args, h), tdl.cross_ffn_step_ref(*args, h),
               dt, "out")
    _runs_sequence(lambda: tdl.cross_ffn_step(*args, h),
                   {"layernorm_kernel": 1, "gemm_partial_kernel": 4,
                    "layer_cross_attn_kernel": 1, "residual_ln_kernel": 1,
                    "gemm_epilogue_kernel": 1, "residual_epilogue_kernel": 1})
    _runs_sequence(lambda: tdl.self_attn_step(*self_args, pos, h, key_pad=kp),
                   tdl.self_kernels(dt == torch.bfloat16))


# (batch, heads, head_dim, lmax, pos, key_pad) of the bf16 step on the
# cluster product: B 1, 3, 64, 65 and 256 (four row tiles), the first and
# the last cache row, head dims 64, 80 and 128, 8 heads (one a rank), 12
# and 16 heads (two a rank) and 3 (an idle rank)
SELF_CLUSTER_CASES = [
    (1, 8, 128, 9, 0, False), (1, 8, 128, 9, 8, True),
    (3, 8, 64, 7, 6, True), (3, 8, 64, 7, 0, False),
    (64, 8, 128, 51, 25, True), (65, 8, 80, 9, 8, False),
    (65, 8, 80, 9, 0, True), (256, 8, 128, 51, 50, True),
    (256, 8, 128, 51, 0, False), (3, 12, 64, 7, 6, True),
    (5, 16, 64, 5, 4, False), (64, 3, 80, 5, 2, True),
]


@pytest.mark.parametrize("case", SELF_CLUSTER_CASES,
                         ids=[f"b{c[0]}-h{c[1]}-dh{c[2]}-pos{c[4]}"
                              f"{'-kp' if c[5] else ''}"
                              for c in SELF_CLUSTER_CASES])
def test_self_attn_step_cluster_kernel(dev, case):
    """The bf16 step (4 launches, no f32 partials in device memory)
    against its plain version: the output, the written cache rows, the
    other rows untouched."""
    b, h, dh, lmax, pos, with_kp = case
    args, _, kp = _layer_inputs(dev, torch.bfloat16,
                                (b, h, dh, 8, lmax, pos, with_kp), seed=b + pos)
    x, ls, lb, wqkv, wout, ck, cv = args
    before = tdl.self_attn_step.launches
    got, gk, gv = tdl.self_attn_step(x, ls, lb, wqkv, wout, ck.clone(),
                                     cv.clone(), pos, h, key_pad=kp)
    torch.cuda.synchronize()
    assert tdl.self_attn_step.launches == before + 1
    want, wk, wv = tdl.self_attn_step_ref(x, ls, lb, wqkv, wout, ck.clone(),
                                          cv.clone(), pos, h, key_pad=kp)
    _close(got, want, torch.bfloat16, "out")
    others = torch.arange(lmax, device=dev) != pos
    for name, g, w, orig in (("k", gk, wk, ck), ("v", gv, wv, cv)):
        assert torch.equal(g[:, others], orig[:, others]), name
        _close(g[:, pos], w[:, pos], torch.bfloat16, name)
    _runs_sequence(lambda: tdl.self_attn_step(*args, pos, h, key_pad=kp),
                   tdl.self_kernels(True))


def _int8_inputs(dev, dt, m, k, n):
    r = np.random.RandomState(m + n)
    x = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(dt).to(dev)
    w8, scale = tim.quantize_int8(torch.from_numpy(
        (r.randn(k, n) * 0.05).astype(np.float32)))
    return x, w8.to(dev), scale.to(dev)


# (M, K, N): ragged shapes the split-K product takes (N % 16 != 0), the two
# flagship shapes, and bf16 shapes of the TMA kernel with ragged M and N
# edges (M 5 in one row tile; M 130 in three, N 4,096 in 32 two-warpgroup
# column tiles)
INT8_SHAPES = [(3, 40, 300), (70, 96, 1000), (64, 1024, 12000),
               (256, 1024, 2048), (5, 1024, 12000), (130, 512, 4096)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_kernel(dev, dt, m, k, n):
    x, w8, scale = _int8_inputs(dev, dt, m, k, n)
    before = tim.int8_matmul.launches
    got = tim.int8_matmul(x, w8, scale)
    torch.cuda.synchronize()
    assert tim.int8_matmul.launches == before + 1
    _close(got, tim.int8_matmul_ref(x, w8, scale), dt, "y")


@pytest.mark.parametrize("m,k,n,kernels", [
    (64, 1024, 12000, ("int8_wgmma_kernel",)),
    (256, 1024, 2048, ("int8_wgmma_kernel",)),
    (3, 40, 300, ("gemm_partial_kernel", "gemm_epilogue_kernel"))])
def test_int8_matmul_path(dev, m, k, n, kernels):
    """bf16 calls at the flagship shapes run the TMA + wgmma kernel alone;
    a shape TMA cannot load runs the split-K product's two kernels."""
    import re

    x, w8, scale = _int8_inputs(dev, torch.bfloat16, m, k, n)
    got = {}
    for name, calls in _kernels_per_call(
            lambda: tim.int8_matmul(x, w8, scale)).items():
        fam = next((f for f in kernels if re.search(
            rf"(?<![A-Za-z0-9_]){f}(?![A-Za-z0-9_])", name)), name)
        got[fam] = got.get(fam, 0.0) + calls
    assert set(got) == set(kernels) and max(got.values()) <= 1 + 1e-6, got


# ---------------------------------------------------------------------------
# ring attention

# (ranks, batch, chunk, heads, head_dim, causal, pad): ragged chunks of one
# and of two 64-row tiles, "dead" rows (key 0 padded: a causal query 0 sees
# no key; every key of batch row 1 padded)
RING_CASES = [
    (4, 3, 5, 2, 40, True, "tail"),
    (3, 2, 7, 4, 16, False, "random"),
    (2, 2, 70, 2, 64, True, "dead"),
    (3, 4, 1, 2, 8, False, "dead"),
    (4, 2, 33, 2, 128, True, "random"),
]


def _ring_inputs(dev, dt, case, seed):
    n, b, c, h, d, causal, pad = case
    t = n * c
    q, k, v, kv_pad, do, _ = _flash_inputs(
        dev, dt, (b, t, t, h, d, causal, "tail" if pad == "tail"
                  else "random"), seed)
    if pad == "dead":
        kv_pad[:, 0] = True
        kv_pad[1 % b] = True
    shards = [x.view(b, n, c, *x.shape[2:]).transpose(0, 1)
              for x in (q, k, v, kv_pad, do)]
    return shards, build_mesh((n,), ("seq",), dev).ring(), causal


@pytest.mark.parametrize("bidir", [False, True], ids=["one_way", "two_way"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES,
                         ids=[f"case{i}" for i in range(len(RING_CASES))])
def test_ring_attention_kernels(dev, dt, case, bidir):
    (q, k, v, kv_pad, do), ring, causal = _ring_inputs(dev, dt, case,
                                                       seed=case[2] + 51)
    fwd, bwd = ((tra.ring_attention_fwd_bidir_shard,
                 tra.ring_attention_bwd_bidir_shard) if bidir else
                (tra.ring_attention_fwd_shard, tra.ring_attention_bwd_shard))
    fwd_ref = getattr(tra, fwd.__name__ + "_ref")
    bwd_ref = getattr(tra, bwd.__name__ + "_ref")
    before = (fwd.launches, bwd.launches)
    got = fwd(q, k, v, kv_pad, ring=ring, causal=causal, return_lse=True)
    want = fwd_ref(q, k, v, kv_pad, ring=ring, causal=causal)
    for name, g, w in zip(("o", "m", "l"), got, want):
        _close(g, w, dt, name)
    o, m, l = got            # the backward runs on the forward kernel's residuals
    grads = bwd(q, k, v, kv_pad, o, m, l, do, ring=ring, causal=causal)
    torch.cuda.synchronize()
    assert fwd.launches > before[0] and bwd.launches > before[1]
    ref = bwd_ref(q, k, v, kv_pad, o, m, l, do, ring=ring, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), grads, ref):
        _close(g, w, dt, name)
    dead = m <= 0.5 * tra.NEG_INF
    if case[-1] == "dead":
        assert bool(dead.any()) and bool(got[0][dead].any())


def test_ring_kernels_on_process_ranks(dev, tmp_path):
    """Rows 6a-6d on a ring of 2 processes sharing the card over gloo (each
    process one rank, its shard and its own entries of the plan; the hops
    staged through pinned host buffers): the kernels within this file's
    limits of their plain versions on the same process ring, f32 and bf16,
    one-way and two-way, and each call's launches as the rank's plan
    predicts (forward: its live steps; backward: a dK/dV and a dQ launch
    per live step and one landing launch)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_p2p_worker as worker
    import torch_parallel_worker as pw
    out = str(tmp_path)
    runs = pw.join(pw.start(out, [], 2, args=[
        os.path.abspath(worker.__file__), out, "cuda_ring"]), 300)
    for r, (rc, text) in enumerate(runs):
        assert rc == 0, f"rank {r}:\n{text[-3000:]}"
    for r in range(2):
        import json
        with open(os.path.join(out, f"cuda_ring.r{r}.json")) as f:
            res = json.load(f)
        live = dict(zip(("one", "two"), res["live"]))
        for tag, got in res["launches"].items():
            n = live[tag.rsplit("/", 1)[1]]
            assert got == [n, 2 * n + 1], (r, tag, got)
        with np.load(os.path.join(out, f"cuda_ring.r{r}.npz")) as z:
            for key in z.files:
                if key.endswith("/got"):
                    name = key[:-4]
                    dt = (torch.bfloat16 if "/bfloat16/" in name
                          else torch.float32)
                    _close(torch.from_numpy(z[key]),
                           torch.from_numpy(z[name + "/want"]), dt,
                           f"rank {r} {name}")


# (ranks, batch, chunk, heads, head_dim, causal, pad): the forward's chunk
# lengths (1, 3, 5, 7 and 10 take the short-chunk tiling; 64, 65 and 1,024
# the 64-row tiles: one full, one ragged, many key tiles) at head dims 64,
# 80 and 128, with dead rows on odd and even rings; then head dims 256 and
# 136 (the DMAX 256 instantiations) short, ragged and long; then the paired
# warps of the DMAX 256 forward at the training chunks (C 5 at B 64, H 4;
# C 7 and 21), dead rows (which attend uniformly) at head dims 200 and 136,
# whose column halves split off a 128-column boundary, and a causal chunk of
# three key tiles with scattered pads.  The bf16 forward cases above head
# dim 128 repeat the call 50 times and must get the same bits (one warp of
# a pair reads and writes the carried m and l: a difference is a race)
RING_FWD_CASES = [
    (4, 2, 1, 2, 64, True, "dead"),
    (3, 3, 3, 2, 80, False, "dead"),
    (4, 3, 5, 2, 128, True, "tail"),
    (3, 2, 7, 2, 64, False, "random"),
    (2, 2, 10, 2, 80, True, "dead"),
    (4, 2, 64, 2, 128, True, "tail"),
    (3, 2, 65, 2, 80, True, "dead"),
    (2, 1, 1024, 2, 64, True, "random"),
    (4, 3, 5, 2, 256, True, "tail"),
    (3, 2, 65, 2, 256, True, "dead"),
    (2, 1, 300, 2, 136, True, "random"),
    (2, 64, 5, 4, 256, True, "tail"),
    (3, 8, 7, 4, 256, False, "tail"),
    (3, 4, 21, 4, 256, False, "tail"),
    (4, 3, 5, 2, 200, True, "dead"),
    (3, 2, 21, 2, 136, True, "dead"),
    (4, 2, 130, 2, 256, True, "random"),
]


@pytest.mark.parametrize("bidir", [False, True], ids=["one_way", "two_way"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_FWD_CASES,
                         ids=[f"n{c[0]}_c{c[2]}_d{c[4]}"
                              for c in RING_FWD_CASES])
def test_ring_forward_kernels(dev, dt, case, bidir):
    """o, m and l of the forward kernels against the plain version, and one
    launch per ring step that has a live rank."""
    (q, k, v, kv_pad, _), ring, causal = _ring_inputs(
        dev, dt, case, seed=case[2] + case[4])
    fwd = (tra.ring_attention_fwd_bidir_shard if bidir
           else tra.ring_attention_fwd_shard)
    n = case[0]
    before = fwd.launches
    got = fwd(q, k, v, kv_pad, ring=ring, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    busy = [s for s in range(tra.ring_steps(n, bidir))
            if any(tra.visits(n, s, r, causal, bidir) for r in range(n))]
    assert fwd.launches - before == len(busy)
    want = getattr(tra, fwd.__name__ + "_ref")(q, k, v, kv_pad, ring=ring,
                                               causal=causal)
    for name, g, w in zip(("o", "m", "l"), got, want):
        _close(g, w, dt, name)
    dead = want[1] <= 0.5 * tra.NEG_INF
    assert torch.equal(got[1][dead], want[1][dead])
    if case[-1] == "dead":
        assert bool(dead.any()) and bool(got[0][dead].any())
    if dt == torch.bfloat16 and case[4] > 128:
        _repeat_bit_equal(lambda: fwd(q, k, v, kv_pad, ring=ring,
                                      causal=causal, return_lse=True))


# the forward's cases, and dead rows on an even ring at a chunk of three
# tiles: each causal diagonal block has key tiles in the future of query
# tile 0, whose dead rows still add to their dv
RING_BWD_CASES = RING_FWD_CASES + [(4, 2, 130, 2, 64, True, "dead")]


@pytest.mark.parametrize("bidir", [False, True], ids=["one_way", "two_way"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_BWD_CASES,
                         ids=[f"n{c[0]}_c{c[2]}_d{c[4]}"
                              for c in RING_BWD_CASES])
def test_ring_backward_kernels(dev, dt, case, bidir):
    """dq, dk and dv of the backward kernels against the plain version on
    the plain forward's residuals, and a dK/dV and a dQ launch per ring
    step that has a live rank plus one landing launch per call."""
    (q, k, v, kv_pad, do), ring, causal = _ring_inputs(
        dev, dt, case, seed=case[2] + case[4] + 1)
    bwd = (tra.ring_attention_bwd_bidir_shard if bidir
           else tra.ring_attention_bwd_shard)
    fwd_ref = (tra.ring_attention_fwd_bidir_shard_ref if bidir
               else tra.ring_attention_fwd_shard_ref)
    n = case[0]
    o, m, l = fwd_ref(q, k, v, kv_pad, ring=ring, causal=causal)
    before = bwd.launches
    got = bwd(q, k, v, kv_pad, o, m, l, do, ring=ring, causal=causal)
    torch.cuda.synchronize()
    busy = [s for s in range(tra.ring_steps(n, bidir))
            if any(tra.visits(n, s, r, causal, bidir) for r in range(n))]
    assert bwd.launches - before == 2 * len(busy) + 1
    want = getattr(tra, bwd.__name__ + "_ref")(q, k, v, kv_pad, o, m, l, do,
                                               ring=ring, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, dt, name)
    if case[-1] == "dead":
        assert bool((m <= 0.5 * tra.NEG_INF).any())


def test_ring_attention_autograd(dev):
    """``ring_attention(impl="pallas")`` on CUDA tensors runs the two-way
    kernels both ways and agrees with the per-hop ring."""
    n, b, c, h, d = 4, 2, 5, 2, 40
    r = np.random.RandomState(7)
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32)).to(dev)
    q0 = t(b, n * c, h, d) * d ** -0.5
    k0, v0, do = t(b, n * c, h, d), t(b, n * c, h, d), t(b, n * c, h, d)
    kv_pad = torch.zeros((b, n * c), dtype=torch.bool, device=dev)
    kv_pad[:, -3:] = True
    mesh = build_mesh((n,), ("seq",), dev)
    outs = []
    for impl in ("pallas", "xla"):
        q, k, v = (x.clone().requires_grad_(True) for x in (q0, k0, v0))
        before = tra.ring_attention_bwd_bidir_shard.launches
        o = ring_attention(q, k, v, mesh, causal=True, kv_pad=kv_pad,
                           impl=impl)
        grads = torch.autograd.grad(o, (q, k, v), do)
        ran = tra.ring_attention_bwd_bidir_shard.launches > before
        assert ran == (impl == "pallas")
        outs.append((o.detach(), *grads))
    for name, g, w in zip(("o", "dq", "dk", "dv"), *outs):
        _close(g, w, torch.float32, name)


# ---------------------------------------------------------------------------
# repeated calls: the kernels sum in a fixed order, so a call repeated on
# the same inputs must give the same bits (a difference is a race)

def _repeat_bit_equal(fn, calls: int = 50):
    first = [t.clone() for t in fn()]
    torch.cuda.synchronize()
    for i in range(calls - 1):
        again = fn()
        for j, (a, b) in enumerate(zip(first, again)):
            assert torch.equal(a, b), (
                f"call {i + 1}, output {j}: {int((a != b).sum())} of "
                f"{a.numel()} elements differ, max "
                f"{float((a.float() - b.float()).abs().max()):.4g}")


@pytest.mark.parametrize("case", [SELF_CLUSTER_CASES[i] for i in (4, 7, 10)],
                         ids=["b64-h8-dh128-pos25", "b256-h8-dh128-pos50",
                              "b5-h16-dh64-pos4"])
def test_self_attn_step_repeats_bit_equal(dev, case):
    """50 bf16 calls on the same inputs: the same output and written cache
    rows every time."""
    b, h, dh, lmax, pos, with_kp = case
    args, _, kp = _layer_inputs(dev, torch.bfloat16,
                                (b, h, dh, 8, lmax, pos, with_kp), seed=b + pos)
    x, ls, lb, wqkv, wout, ck, cv = args

    def call():
        out, k, v = tdl.self_attn_step(x, ls, lb, wqkv, wout, ck.clone(),
                                       cv.clone(), pos, h, key_pad=kp)
        return out, k[:, pos], v[:, pos]
    _repeat_bit_equal(call)


@pytest.mark.parametrize("quantized", [True, False], ids=["int8w", "bf16w"])
def test_head_argmax_repeats_bit_equal(dev, quantized):
    """50 bf16 head calls at the flagship's widths on the same inputs (a
    planted tie among them): the same tokens every time."""
    (x, ln_s, ln_b, w, bias), scales, chunk = _head_inputs(
        dev, torch.bfloat16, 64, 1024, 12000, quantized, seed=7)
    w, bias = w.clone(), bias.clone()
    w[:, 61] = w[:, 2]
    bias[2] = bias[61] = 1e4
    if scales is not None:
        scales[0, 61] = scales[0, 2]
    _repeat_bit_equal(lambda: (tdh.head_argmax(x, ln_s, ln_b, w, bias,
                                               chunk=chunk, scales=scales),))


@pytest.mark.parametrize("m,k,n", [(64, 1024, 12000), (256, 1024, 2048),
                                   (130, 512, 4096)])
def test_int8_matmul_repeats_bit_equal(dev, m, k, n):
    """50 bf16 calls of the TMA + wgmma kernel on the same inputs: the same
    bits every time."""
    x, w8, scale = _int8_inputs(dev, torch.bfloat16, m, k, n)
    _repeat_bit_equal(lambda: (tim.int8_matmul(x, w8, scale),))
