"""The port's per-layer decode step against the JAX package's.

``self_attn_step_ref`` and ``cross_ffn_step_ref`` (the plain PyTorch
versions of the CUDA kernels) must compute what the JAX ``self_attn_step``
and ``cross_ffn_step`` compute (their Pallas kernels in interpret mode, as
the JAX tests run them on the CPU) on the same numpy inputs, and the port's
``TransformerDecoder(use_pallas_decode=True)`` must step like the JAX one.
CPU tensors never launch the CUDA kernels.

Tolerances: f32 within 1e-5 absolute and relative (the two differ only in
the order of f32 sums).  The bf16 case rounds the running output to bf16
after each head; it is held to 1 bf16 ulp of max|JAX|, while rounding once
after all heads (the order the kernel must not take) lands further away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.ops.pallas import decode_layer as jdl
from blt_vqg_tpu.ops.transformer import TransformerDecoder as JaxDecoder
from blt_vqg_tpu_torch.convert import to_flax
from blt_vqg_tpu_torch.ops.kernels import decode_layer as tdl
from blt_vqg_tpu_torch.ops.kernels import decode_stream as tds
from blt_vqg_tpu_torch.ops.kernels.decode_stream import layernorm
from blt_vqg_tpu_torch.ops.transformer import TransformerDecoder


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, D, H, F, NL, L, TC = 3, 32, 4, 64, 2, 6, 3
DH = D // H
SELF_ARGS = ("x", "ln_scale", "ln_bias", "w_qkv", "w_out", "cache_k",
             "cache_v")
CROSS_ARGS = ("x", "lsc", "lbc", "wq", "ck", "cv", "src_pad", "wo", "lsf",
              "lbf", "w1", "b1", "w2", "b2")


def _self_inputs(seed, width=D, heads=H):
    r = np.random.RandomState(seed)
    n = lambda *s, sc=0.3: (r.randn(*s) * sc).astype(np.float32)
    dh = width // heads
    return {"x": n(B, width, sc=1.0), "ln_scale": 1.0 + n(width, sc=0.1),
            "ln_bias": n(width, sc=0.1), "w_qkv": n(heads, width, 3 * dh),
            "w_out": n(heads, dh, width),
            "cache_k": n(heads, L, B, dh, sc=1.0),
            "cache_v": n(heads, L, B, dh, sc=1.0)}


def _key_pad(seed, pos):
    """Pad-marked keys at rows <= pos only (the precondition); batch row 0
    has every visible key marked, so its weights come out uniform."""
    r = np.random.RandomState(seed)
    kp = (r.rand(L, B) < 0.4).astype(np.float32)
    kp[pos + 1:] = 0.0
    kp[:pos + 1, 0] = 1.0
    return kp


@pytest.mark.parametrize("pos,with_kp", [(0, False), (0, True), (3, False),
                                         (3, True), (L - 1, True)])
def test_self_attn_step_ref_matches_jax(pos, with_kp):
    a = _self_inputs(pos + 1)
    kp = _key_pad(pos + 20, pos) if with_kp else None
    want = jdl.self_attn_step(*(jnp.asarray(a[k]) for k in SELF_ARGS), pos,
                              H, key_pad=None if kp is None else jnp.asarray(kp))
    t = {k: torch.from_numpy(a[k].copy()) for k in SELF_ARGS}
    before = tdl.self_attn_step.launches
    got = tdl.self_attn_step(*(t[k] for k in SELF_ARGS), pos, H,
                             key_pad=None if kp is None
                             else torch.from_numpy(kp))
    assert tdl.self_attn_step.launches == before      # CPU: plain version
    # the caches are written in place at pos, and nowhere else
    assert got[1] is t["cache_k"] and got[2] is t["cache_v"]
    for i, name in ((1, "cache_k"), (2, "cache_v")):
        others = np.arange(L) != pos
        np.testing.assert_array_equal(got[i].numpy()[:, others],
                                      a[name][:, others])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_self_attn_step_bf16_rounds_after_each_head():
    """bf16: the output is rounded after each head in head order, as the
    TPU grid does; rounding once after all heads is a different result."""
    pos, heads, width = 4, 8, 64
    a = _self_inputs(5, width=width, heads=heads)
    a["x"] *= 40.0                       # residual >> per-head partials
    bf = {k: torch.from_numpy(a[k]).to(torch.bfloat16)
          if k not in ("ln_scale", "ln_bias") else torch.from_numpy(a[k])
          for k in SELF_ARGS}
    j = {k: jnp.asarray(bf[k].float().numpy()).astype(
        jnp.bfloat16 if bf[k].dtype == torch.bfloat16 else jnp.float32)
         for k in SELF_ARGS}
    want = np.asarray(jdl.self_attn_step(*(j[k] for k in SELF_ARGS), pos,
                                         heads)[0]).astype(np.float32)
    got = tdl.self_attn_step_ref(*(bf[k].clone() for k in SELF_ARGS), pos,
                                 heads)[0].float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 1 * ulp

    # the order the kernel must not take: all heads summed in f32, rounded
    # once (the plain version's arithmetic otherwise)
    x = bf["x"]
    xn = layernorm(x, bf["ln_scale"], bf["ln_bias"]).to(torch.bfloat16)
    acc = x.float()
    dh = width // heads
    for h in range(heads):
        qkv = xn.float() @ bf["w_qkv"][h].float()
        q = qkv[:, :dh] * dh ** -0.5
        kc = bf["cache_k"][h].float().clone()
        vc = bf["cache_v"][h].float().clone()
        kc[pos] = qkv[:, dh:2 * dh].to(torch.bfloat16).float()
        vc[pos] = qkv[:, 2 * dh:].to(torch.bfloat16).float()
        s = (q[None] * kc).sum(-1).masked_fill(
            (torch.arange(L) > pos)[:, None], tdl.NEG_INF)
        ctx = (torch.softmax(s, 0)[:, :, None] * vc).sum(0)
        acc = acc + ctx.to(torch.bfloat16).float() @ bf["w_out"][h].float()
    once = acc.to(torch.bfloat16).float().numpy()
    assert np.abs(once - want).max() > 1 * ulp


def _cross_inputs(seed):
    r = np.random.RandomState(seed)
    n = lambda *s, sc=0.3: (r.randn(*s) * sc).astype(np.float32)
    src_pad = np.zeros((B, TC), bool)
    src_pad[:, 2] = True            # a padded context column
    src_pad[1] = True               # a row whose every key is masked
    return {"x": n(B, D, sc=1.0), "lsc": 1.0 + n(D, sc=0.1),
            "lbc": n(D, sc=0.1), "wq": n(D, D), "ck": n(B, TC, H, DH, sc=1.0),
            "cv": n(B, TC, H, DH, sc=1.0), "src_pad": src_pad, "wo": n(D, D),
            "lsf": 1.0 + n(D, sc=0.1), "lbf": n(D, sc=0.1), "w1": n(D, F),
            "b1": n(F, sc=0.1), "w2": n(F, D), "b2": n(D, sc=0.1)}


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_ffn_step_ref_matches_jax(seed):
    a = _cross_inputs(seed)
    want = jdl.cross_ffn_step(*(jnp.asarray(a[k]) for k in CROSS_ARGS), H)
    before = tdl.cross_ffn_step.launches
    got = tdl.cross_ffn_step(*(torch.from_numpy(a[k]) for k in CROSS_ARGS),
                             H)
    assert tdl.cross_ffn_step.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the fully masked row attends uniformly: its context is the key mean
    unmasked = dict(a, src_pad=np.zeros_like(a["src_pad"]))
    unmasked["ck"] = a["ck"].copy()
    unmasked["ck"][1] = 0.0         # equal scores: uniform weights
    same = tdl.cross_ffn_step(*(torch.from_numpy(unmasked[k])
                                for k in CROSS_ARGS), H)
    np.testing.assert_allclose(got[1].numpy(), same[1].numpy(), atol=1e-6)


def _decoders():
    port = TransformerDecoder(D, NL, H, F, dtype=torch.float32,
                              max_decode_len=L, use_pallas_decode=True)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    params, _ = to_flax(port.state_dict())
    jax_dec = JaxDecoder(D, NL, H, F, dtype=jnp.float32, max_decode_len=L,
                         use_pallas_decode=True)
    return port, jax_dec, params


@pytest.mark.parametrize("with_kp", [False, True])
def test_decoder_steps_match_jax(with_kp):
    """Six steps of the per-layer decoder: outputs and caches [H,L,B,Dh]."""
    port, jax_dec, params = _decoders()
    assert port.cache_batch_axis == 2
    r = np.random.RandomState(4)
    cross = [(r.randn(B, TC, H, DH).astype(np.float32),
              r.randn(B, TC, H, DH).astype(np.float32)) for _ in range(NL)]
    src = np.zeros((B, 1, 1, TC), bool)
    src[:, :, :, 2] = True
    src[1] = True
    kp = np.zeros((B, L), bool)
    j_caches = jax_dec.apply({"params": params}, B, L,
                             method=JaxDecoder.init_cache)
    t_caches = port.init_cache(B, L)
    assert tuple(t_caches[0][0].shape) == (H, L, B, DH)
    j_cross = [(jnp.asarray(k), jnp.asarray(v)) for k, v in cross]
    t_cross = [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in cross]
    layers = port.layer_weights()
    jax_step = jax.jit(lambda *a: jax_dec.apply({"params": params}, *a,
                                                method=JaxDecoder.step))
    for pos in range(L):
        x = r.randn(B, 1, D).astype(np.float32)
        if with_kp:
            kp[:, pos] = r.rand(B) < 0.4
        jkp = jnp.asarray(kp) if with_kp else None
        want, j_caches = jax_step(jnp.asarray(x), j_caches, j_cross,
                                  jnp.asarray(pos, jnp.int32),
                                  jnp.asarray(src), jkp)
        with torch.no_grad():
            got, _ = port.step(torch.from_numpy(x), t_caches, t_cross, pos,
                               torch.from_numpy(src),
                               torch.from_numpy(kp) if with_kp else None,
                               layers=layers)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=f"pos {pos}")
    for (jk, jv), (tk, tv) in zip(j_caches, t_caches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_decode_weights_layouts():
    """The regrouped weights are the JAX ``_step_pallas`` layouts, built
    once per layer and kept while the parameters stay the same."""
    port, _, _ = _decoders()
    layer = port.layers[0]
    w = layer.decode_weights()
    assert layer.decode_weights() is w
    q = layer.self_attn.q_proj.weight.detach().T
    np.testing.assert_array_equal(w["wqkv"][1][:, :DH].numpy(),
                                  q[:, DH:2 * DH].numpy())
    o = layer.self_attn.out_proj.weight.detach().T
    np.testing.assert_array_equal(w["wout"][2].numpy(),
                                  o[2 * DH:3 * DH].numpy())
    with torch.no_grad():
        layer.ffn.ffn_in.bias.add_(1.0)
    assert layer.decode_weights() is not w


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cross_ffn_args_one_scratch_allocation(dt):
    """One scratch allocation holds every piece of cross_ffn_step's scratch
    (256-byte aligned, disjoint) and the split-K workspace its four
    products need (decode_stream.gemm_workspace), which it hands over."""
    b, d, h, f, tc = 3, 32, 4, 72, 3
    z = lambda *s, t=dt: torch.zeros(s, dtype=t)
    f32 = lambda *s: z(*s, t=torch.float32)
    a, out, buf = tdl._prepare_cross(
        z(b, d), f32(d), f32(d), z(d, d), z(b, tc, h, d // h),
        z(b, tc, h, d // h), torch.zeros((b, tc), dtype=torch.bool), z(d, d),
        f32(d), f32(d), z(d, f), f32(f), z(f, d), f32(d), h)
    assert out.shape == (b, d) and out.dtype == dt
    floats = tds.gemm_workspace(b, tdl.cross_products(d, f),
                                dt == torch.bfloat16)
    assert a.part_floats == floats
    act = torch.finfo(dt).bits // 8
    sizes = dict(xn=b * d * act, ctx=b * d * act, x1=b * d * 4,
                 h1=b * f * act, part=floats * 4)
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    spans = sorted((getattr(a, n), getattr(a, n) + s) for n, s in sizes.items())
    assert all((p - lo) % 256 == 0 for p, _ in spans)
    assert spans[0][0] >= lo and spans[-1][1] <= hi
    assert all(e <= p for (_, e), (p, _) in zip(spans, spans[1:]))
