"""The port's whole-stack decode step against the JAX package's.

``decode_stack_step_ref`` (the plain PyTorch version of the CUDA kernel)
must compute what the JAX ``decode_stack_step`` computes (its Pallas kernel
in interpret mode, as the JAX tests run it on the CPU) on the same numpy
inputs, in f32 with bf16-free weights and with int8 weights on all or one
kind; ``quantize_stack`` must be bit-exact and the port's ``stream_prep``
must build the same stacks as the JAX one.  CPU tensors never launch the
CUDA kernel.  Tolerance: 1e-5 absolute and relative on f32 activations
(the two differ only in the order of f32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.ops.pallas import decode_stream as jds
from blt_vqg_tpu.ops.transformer import TransformerDecoder as JaxDecoder
from blt_vqg_tpu_torch.convert import to_flax
from blt_vqg_tpu_torch.ops.kernels import decode_stream as tds
from blt_vqg_tpu_torch.ops.transformer import TransformerDecoder


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, D, H, NL, F, LMAX, TC = 3, 32, 4, 2, 64, 6, 3
DH = D // H
KINDS = ("wqkv", "wout", "wqc", "woc", "w1", "w2")


def test_quantize_stack_bit_exact():
    r = np.random.RandomState(0)
    w = (r.randn(2, 3, 16, 10) * 0.3).astype(np.float32)
    w[0, 0, :, 0] = 0.0                                   # amax 0 column
    # exact halves: amax 127 gives scale 1, so these round half to even
    w[0, 1, :6, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    w[0, 1, 6:, 1] = 0.0
    w8_j, s_j = jds.quantize_stack(jnp.asarray(w))
    w8_t, s_t = tds.quantize_stack(torch.from_numpy(w))
    assert w8_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(w8_t.numpy(), np.asarray(w8_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(w8_t[0, 1, :6, 1].numpy(),
                                  [127, 0, 2, 2, 0, -2])


@pytest.mark.parametrize("heads,ffn", [(8, 2048), (4, 64), (6, 63), (1, 7),
                                       (3, 10)])
def test_pick_stages_equal(heads, ffn):
    assert tds.pick_stages(heads, ffn) == jds.pick_stages(heads, ffn)


def _stack_inputs(seed):
    """Random stacked weights/caches at the tiny shapes (numpy, f32)."""
    hc, fc = tds.pick_stages(H, F)
    hpc, fch = H // hc, F // fc
    r = np.random.RandomState(seed)
    n = lambda *s, sc=0.3: (r.randn(*s) * sc).astype(np.float32)
    w = {"wqkv": n(NL, H, D, 3 * DH), "wout": n(NL, H, DH, D),
         "wqc": n(NL, hc, D, hpc * DH), "woc": n(NL, hc, hpc * DH, D),
         "w1": n(NL, fc, D, fch), "w2": n(NL, fc, fch, D)}
    lns = np.stack([1.0 + n(NL, D, sc=0.1) if i % 2 == 0 else n(NL, D, sc=0.1)
                    for i in range(6)], axis=1)
    smask = np.zeros((TC, B), np.int32)
    smask[2, 1] = 1
    other = dict(x=n(B, D, sc=1.0), lns=lns,
                 cache_k=n(NL, H, LMAX, B, DH, sc=1.0),
                 cache_v=n(NL, H, LMAX, B, DH, sc=1.0),
                 ckc=n(NL, hc, TC, B, hpc * DH, sc=1.0),
                 cvc=n(NL, hc, TC, B, hpc * DH, sc=1.0), smask=smask,
                 b1=n(NL, fc, 1, fch, sc=0.1), b2=n(NL, 1, D, sc=0.1))
    kp = (r.rand(LMAX, B) < 0.4).astype(np.float32)
    kp[0] = 1.0                                  # the <pad> seed key
    kp_cur = (r.rand(1, B) < 0.5).astype(np.float32)
    return w, other, kp, kp_cur, hc, fc


def _run(fn, conv, w, o, pos, scales, kp, kp_cur, hc, fc):
    c = lambda a: None if a is None else conv(a)
    return fn(c(o["x"]), pos, c(o["lns"]), c(w["wqkv"]), c(w["wout"]),
              c(o["cache_k"]), c(o["cache_v"]), c(w["wqc"]), c(w["woc"]),
              c(o["ckc"]), c(o["cvc"]), c(o["smask"]), c(w["w1"]),
              c(o["b1"]), c(w["w2"]), c(o["b2"]), num_heads=H,
              cross_stages=hc, ffn_stages=fc,
              weight_scales=(None if scales is None
                             else tuple(c(s) for s in scales)),
              key_pad=c(kp), key_pad_cur=c(kp_cur))


# bf16-free weights at the first, a middle and the last position, with and
# without the pad-key mask; then int8 on all kinds and on single kinds
CASES = ([(pos, "none", kp) for pos in (0, LMAX // 2, LMAX - 1)
          for kp in (False, True)]
         + [(LMAX // 2, "all", True), (LMAX - 1, "wout", False),
            (1, "w1", True)])


# the JAX step compiled once per signature (the weights' dtypes, the
# key-pad mask present or not) and shared by the cases at other positions:
# pos reaches the kernel as an array
_JAX_STEP = jax.jit(jds.decode_stack_step, static_argnames=(
    "num_heads", "cross_stages", "ffn_stages"))


@pytest.mark.parametrize("pos,quant,with_kp", CASES)
def test_ref_matches_jax_decode_stack_step(pos, quant, with_kp):
    w, o, kp, kp_cur, hc, fc = _stack_inputs(seed=pos + 7)
    scales = None
    if quant != "none":
        scales = [None] * 6
        for i, k in enumerate(KINDS):
            if quant in ("all", k):
                w8, s = tds.quantize_stack(torch.from_numpy(w[k]))
                w[k], scales[i] = w8.numpy(), s.numpy()
    if not with_kp:
        kp = kp_cur = None
    want = _run(_JAX_STEP, jnp.asarray, w, o, pos, scales, kp, kp_cur, hc,
                fc)
    before = tds.decode_stack_step.launches
    got = _run(tds.decode_stack_step, torch.from_numpy, w, o, pos, scales,
               kp, kp_cur, hc, fc)
    assert tds.decode_stack_step.launches == before   # CPU: plain version
    ref = _run(tds.decode_stack_step_ref, torch.from_numpy, w, o, pos,
               scales, kp, kp_cur, hc, fc)
    for g, r_, wv in zip(got, ref, want):
        np.testing.assert_array_equal(g.numpy(), r_.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("weight_dtype", ["bfloat16", "int8"])
def test_stream_prep_matches_jax(weight_dtype):
    hc, fc = tds.pick_stages(H, F)
    port = TransformerDecoder(D, NL, H, F, dtype=torch.float32,
                              max_decode_len=LMAX, use_stream_decode=True,
                              stream_weight_dtype=weight_dtype)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    params, _ = to_flax(port.state_dict())
    jax_dec = JaxDecoder(D, NL, H, F, dtype=jnp.float32, max_decode_len=LMAX,
                         use_stream_decode=True,
                         stream_weight_dtype=weight_dtype)
    r = np.random.RandomState(4)
    cross = [(r.randn(B, TC, H, DH).astype(np.float32),
              r.randn(B, TC, H, DH).astype(np.float32)) for _ in range(NL)]
    src = np.zeros((B, 1, 1, TC), bool)
    src[1, :, :, 2] = True
    want = jax_dec.apply({"params": params},
                         [(jnp.asarray(k), jnp.asarray(v)) for k, v in cross],
                         jnp.asarray(src), B,
                         method=JaxDecoder.stream_prep)
    got = port.stream_prep([(torch.from_numpy(k), torch.from_numpy(v))
                            for k, v in cross], torch.from_numpy(src), B)
    assert set(got) == set(want)
    for key in ("lns", "ckc", "cvc", "smask", "b1", "b2"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for gs, ws in zip(got["stacks"], want["stacks"]):
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    if weight_dtype == "int8":
        for gs, ws in zip(got["scales"], want["scales"]):
            np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    else:
        assert got["scales"] is None and want["scales"] is None


# ---------------------------------------------------------------------------
# the split-K product's tiling (csrc/common.cuh) and the step's one scratch
# allocation, pure Python

from blt_vqg_tpu_torch.ops.kernels import decode_layer as tdl  # noqa: E402

# (batch, heads, head_dim, ffn) of the card tests' stack cases
# (tests/test_torch_kernels_cuda.py STACK_CASES) and of the flagship
# (emb 1024, 8 heads, FFN 2048) at b64, b128 and b512
STACK_WIDTHS = [(3, 4, 16, 72), (70, 2, 40, 64), (8, 8, 128, 2048),
                (64, 8, 128, 2048), (128, 8, 128, 2048), (512, 8, 128, 2048)]


def _walk(batch, groups, depth, width, bf16):
    """Walks gemm_partial_kernel's grid: returns {(partial, row tile,
    column tile): the offsets of its first and last element, for each
    block that writes it}, a partial being blockIdx.y = group * splits +
    K split, and the kernel's padded width Np and height Bp."""
    t = tds.GEMM_TILE
    splits = tds.gemm_splits(depth, bf16)
    gx, gy, gz = -(-width // t), groups * splits, -(-batch // t)
    np_, bp = gx * t, gz * t
    written = {}
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):
                first = (y * bp + z * t) * np_ + x * t
                written.setdefault((y, z, x), []).append(
                    (first, first + (t - 1) * np_ + t - 1))
    return written, np_, bp


def _check_products(batch, products, bf16):
    """Each product's blocks write every (partial, tile) once inside the
    workspace, and the epilogue's reads of output (b, n) — the partials of
    its group (all groups, in order, for a reduce product) in split order,
    at (((g * splits + s) * Bp + b) * Np + n) — land in what they wrote."""
    floats = tds.gemm_workspace(batch, products, bf16)
    t = tds.GEMM_TILE
    for groups, depth, width, reduce in products:
        splits = tds.gemm_splits(depth, bf16)
        written, np_, bp = _walk(batch, groups, depth, width, bf16)
        assert sorted(written) == [
            (y, z, x) for y in range(groups * splits)
            for z in range(-(-batch // t)) for x in range(-(-width // t))]
        assert all(len(w) == 1 for w in written.values())
        assert max(last for (w,) in written.values() for last in w) < floats
        for b, n in {(0, 0), (batch - 1, width - 1), (batch // 2, width // 3)}:
            for g in range(groups):
                for sp in range(splits):
                    y = g * splits + sp
                    off = ((y * bp) + b) * np_ + n
                    (first, last), = written[(y, b // t, n // t)]
                    assert first <= off <= last
                    assert (off - first) % np_ == n % t
                    assert (off - first) // np_ == b % t


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", STACK_WIDTHS,
                         ids=[f"b{c[0]}-h{c[1]}-dh{c[2]}-f{c[3]}"
                              for c in STACK_WIDTHS])
def test_stack_products_partials_reach_their_epilogue(case, bf16):
    b, h, dh, f = case
    hc, fc = tds.pick_stages(h, f)
    _check_products(b, tds.stack_products(h * dh, h, hc, fc, f), bf16)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", [(3, 32, 72), (70, 80, 64), (20, 1024, 2048),
                                  (64, 1024, 2048), (256, 1024, 2048)],
                         ids=["b3", "b70", "b20", "b64", "b256"])
def test_cross_products_partials_reach_their_epilogue(case, bf16):
    b, d, f = case
    _check_products(b, tdl.cross_products(d, f), bf16)


def test_stack_products_match_the_weights():
    """stack_products has the (groups, depth, width) of the stacked weight
    layouts decode_stack_step takes, the out products reducing."""
    d, h, f = 64, 4, 72
    hc, fc = tds.pick_stages(h, f)
    dh, w, fch = d // h, (h // hc) * d // h, f // fc
    shapes = [(h, d, 3 * dh), (h, dh, d), (hc, d, w), (hc, w, d),
              (fc, d, fch), (fc, fch, d)]
    assert [p[:3] for p in tds.stack_products(d, h, hc, fc, f)] == shapes
    assert [p[3] for p in tds.stack_products(d, h, hc, fc, f)] == [0, 1] * 3


def _scratch_pieces(a, buf, names):
    """The pieces' pointers: distinct, 256-byte aligned, inside buf."""
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    ptrs = [getattr(a, n) for n in names]
    assert len(set(ptrs)) == len(ptrs)
    assert all(lo <= p < hi and (p - lo) % 256 == 0 for p in ptrs)
    return sorted(ptrs)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_stack_args_one_scratch_allocation(dt):
    b, h, dh, f, nl, lmax, pos = 3, 4, 16, 72, 2, 7, 3
    hc, fc = tds.pick_stages(h, f)
    d, w, fch = h * dh, (h // hc) * dh, f // fc
    z = lambda *s, t=dt: torch.zeros(s, dtype=t)
    weights = (z(nl, h, d, 3 * dh), z(nl, h, dh, d), z(nl, hc, d, w),
               z(nl, hc, w, d), z(nl, fc, d, fch), z(nl, fc, fch, d))
    w8, s8 = tds.quantize_stack(weights[5].float())
    weights = weights[:5] + (w8,)
    scales = (None,) * 5 + (s8,)
    a, (x_out, k_new, v_new), buf = tds._prepare(
        z(b, d), pos, z(nl, 6, d, t=torch.float32), weights, scales,
        z(nl, h, lmax, b, dh), z(nl, h, lmax, b, dh), z(nl, hc, 3, b, w),
        z(nl, hc, 3, b, w), z(3, b, t=torch.int32),
        z(nl, fc, 1, fch, t=torch.float32), z(nl, 1, d, t=torch.float32),
        None, None, hc, fc)
    assert list(a.w_i8) == [0, 0, 0, 0, 0, 1]
    assert a.act_bf16 == int(dt == torch.bfloat16)
    assert x_out.shape == (b, d) and k_new.shape == v_new.shape == (nl, h, b, dh)
    floats = tds.gemm_workspace(b, tds.stack_products(d, h, hc, fc, f),
                                dt == torch.bfloat16)
    assert a.part_floats == floats
    act = torch.finfo(dt).bits // 8
    sizes = dict(xn=b * d * act, ctx=h * b * dh * act, ctxc=hc * b * w * act,
                 h1=fc * b * fch * act, part=floats * 4)
    ptrs = _scratch_pieces(a, buf, sizes)
    # in order, each piece ends before the next begins
    ends = [getattr(a, n) + sizes[n] for n in sizes]
    assert all(e <= p for e, p in zip(sorted(ends)[:-1], ptrs[1:]))
    assert sorted(ends)[-1] <= buf.data_ptr() + buf.numel()
