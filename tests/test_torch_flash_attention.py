"""The port's flash attention against the JAX package's ``flash_attention``.

On the CPU the port's autograd Function runs its plain versions
(``flash_attention_fwd_ref`` and ``flash_attention_bwd_ref``); the JAX
function runs its Pallas kernels in interpret mode, as
tests/test_flash_attention.py and tests/test_flash_backward.py run them.
The same numpy-made q, k, v, key-pad mask and output cotangent go to both;
the forward output and the gradients (``jax.vjp`` against
``torch.autograd.grad``) must agree.  Tolerances: f32 to 1e-5 absolute and
relative (the two differ in the order of f32 sums); bf16 to 1e-2 of the
tensor's largest magnitude (both round p to bf16 before the PV product and
round every output, after sums taken in another order, so one-ulp flips
move an output by up to ~0.8% of its scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.ops.pallas.flash_attention import flash_attention as jflash
from blt_vqg_tpu_torch.ops.kernels import flash_attention as tfa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = 1e-2


def _inputs(b, tq, tk, h, d, seed, pad=None):
    r = np.random.RandomState(seed)
    n = lambda *s: r.randn(*s).astype(np.float32)
    q = n(b, tq, h, d) * d ** -0.5
    k, v, do = n(b, tk, h, d), n(b, tk, h, d), n(b, tq, h, d)
    kv_pad = None
    if pad == "tail":
        kv_pad = np.arange(tk)[None, :] >= r.randint(1, tk + 1, b)[:, None]
    elif pad in ("random", "dead"):
        kv_pad = r.rand(b, tk) < 0.3
        kv_pad[:, 0] = False
        if pad == "dead":
            kv_pad[1] = True          # every key of batch row 1 masked
    return q, k, v, kv_pad, do


def _jax_run(q, k, v, kv_pad, do, causal, dtype=jnp.float32):
    cast = lambda x: jnp.asarray(x, dtype)

    @jax.jit   # one program: cheaper than the eager interpret-mode kernels
    def run(q, k, v, kv_pad, do):
        fn = lambda q, k, v: jflash(q, k, v, kv_pad, causal=causal)
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(do))
    outs = run(cast(q), cast(k), cast(v),
               None if kv_pad is None else jnp.asarray(kv_pad), cast(do))
    return [np.asarray(x.astype(jnp.float32)) for x in outs]


def _torch_run(q, k, v, kv_pad, do, causal, dtype=torch.float32):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_(True)
               for x in (q, k, v))
    pad = None if kv_pad is None else torch.from_numpy(kv_pad)
    out = tfa.flash_attention(q, k, v, pad, causal)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy() for x in (out, *grads)]


# (batch, tq, tk, heads, head_dim, causal, pad)
CASES = {
    "plain": (2, 16, 16, 2, 8, False, None),
    "causal": (2, 16, 16, 2, 8, True, None),
    "key_pad": (2, 8, 12, 2, 8, False, "tail"),
    "causal_key_pad": (3, 20, 20, 2, 16, True, "random"),
    "ragged": (2, 5, 11, 2, 8, False, "random"),
    "cross": (3, 20, 3, 2, 16, False, "tail"),
    "dead_row": (3, 5, 11, 2, 8, False, "dead"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_f32(case):
    b, tq, tk, h, d, causal, pad = CASES[case]
    args = _inputs(b, tq, tk, h, d, seed=len(case), pad=pad)
    want = _jax_run(*args, causal)
    got = _torch_run(*args, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32_TOL)
    if pad == "dead":
        for g in got:
            assert not g[1].any(), "a dead row must have zero output and grads"


def test_matches_jax_bf16():
    args = _inputs(3, 20, 20, 2, 16, seed=11, pad="random")
    want = _jax_run(*args, True, jnp.bfloat16)
    got = _torch_run(*args, True, torch.bfloat16)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.abs(g - w).max() <= BF16_TOL * np.abs(w).max(), name


@pytest.mark.parametrize("causal,pad", [(False, "random"), (True, "tail"),
                                        (False, "dead")])
def test_bwd_ref_matches_autograd_of_fwd_ref(causal, pad):
    """The plain backward, from the saved (m, l), against autograd through
    the plain forward."""
    q, k, v, kv_pad, do = _inputs(2, 9, 13, 2, 8, seed=3, pad=pad)
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in (q, k, v))
    kv_pad, do = torch.from_numpy(kv_pad), torch.from_numpy(do)
    o, m, l = tfa.flash_attention_fwd_ref(q, k, v, kv_pad, causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tfa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      kv_pad, o.detach(), m.detach(),
                                      l.detach(), do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **F32_TOL)


def test_residuals():
    """m is the row max of the masked logits and l the softmax denominator
    at that max; a dead row has m at the fill and l = 1."""
    q, k, v, kv_pad, _ = _inputs(3, 4, 6, 2, 8, seed=5, pad="dead")
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    kv_pad = torch.from_numpy(kv_pad)
    _, m, l = tfa.flash_attention_fwd_ref(q, k, v, kv_pad)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = s.masked_fill(kv_pad[:, None, None, :], -float("inf"))
    live = torch.tensor([0, 2])
    torch.testing.assert_close(m[live], s[live].amax(-1))
    torch.testing.assert_close(l[live], torch.exp(
        s[live] - m[live][..., None]).sum(-1))
    assert bool((m[1] == tfa.NEG_INF).all()) and bool((l[1] == 1.0).all())


def test_cpu_takes_the_plain_version():
    q, k, v, kv_pad, _ = _inputs(2, 4, 4, 2, 8, seed=1, pad="tail")
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    kv_pad = torch.from_numpy(kv_pad)
    before = tfa.flash_attention_fwd.launches
    got = tfa.flash_attention_fwd(q, k, v, kv_pad)
    want = tfa.flash_attention_fwd_ref(q, k, v, kv_pad)
    assert tfa.flash_attention_fwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_bwd_dq(q, k, v, kv_pad, *want[1:], q,
                                   want[1], False)


# ---------------------------------------------------------------------------
# The bf16 kernels' tiling (``mma_geom``), in pure Python: the kernels run
# whatever tiling the host passes them, after checking it.  The forward
# ("fwd") owns queries and walks key tiles, as dQ does.

GEOM_DIMS = (8, 16, 40, 64, 80, 128)
TRAIN_SHAPES = ((3, 3), (21, 21), (20, 20), (20, 3))   # (Tq, Tk)


def _writes(g, n_bh, length):
    """How often each (b, h) and owned row is written by the grid of
    ``g``: block (x, y), warp w, lane row r writes (b, h) x * groups +
    w // wq, row 16 wq y + 16 (w % wq) + r, where both lie in range (the
    kernels' test before a store; idle groups and rows store nothing)."""
    x, y, w, r = np.meshgrid(np.arange(g.grid_x), np.arange(g.grid_y),
                             np.arange(tfa.MMA_WARPS), np.arange(16),
                             indexing="ij")
    bh = x * g.groups + w // g.wq
    row = y * 16 * g.wq + 16 * (w % g.wq) + r
    ok = (bh < n_bh) & (row < length)
    counts = np.zeros((n_bh, length), np.int64)
    np.add.at(counts, (bh[ok], row[ok]), 1)
    return counts, bh, row


@pytest.mark.parametrize("kernel", ["dkdv", "dq", "fwd"])
def test_bwd_geom_covers_every_row_once(kernel):
    """Every (b, h) and owned row, for owned lengths 1-130 and B*H counts
    that leave the last block's groups idle, is written exactly once; only
    the last block along each grid axis holds idle groups or rows."""
    for length in range(1, 131):
        for n_bh in (1, 3, 5, 6):
            tq, tk = (7, length) if kernel == "dkdv" else (length, 7)
            g = tfa.mma_geom(kernel, tq, tk, 64, n_bh)
            counts, bh, row = _writes(g, n_bh, length)
            assert (counts == 1).all(), (length, n_bh)
            assert g.grid_x * g.groups - n_bh < g.groups
            assert g.grid_y * 16 * g.wq - length < 16 * g.wq
            assert g.wq == (1 if length <= 16 else 2 if length <= 32 else 4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bwd_walk_reaches_every_visible_pair(causal):
    """The walked tiles, with the kernels' causal skipping (dK/dV: query
    tiles wholly before the block's first key, and 16 queries wholly before
    the warp's keys; forward and dQ: key tiles wholly after the block's
    last row, and 16 keys wholly after the warp's rows), cover every
    (query, key) pair that is not causally masked, for Tq and Tk in
    1-130."""
    for tq in range(1, 131, 3):
        for tk in range(1, 131, 4):
            i, j = np.meshgrid(np.arange(tq), np.arange(tk), indexing="ij")
            vis = ~(causal & (j > i))
            g = tfa.mma_geom("dkdv", tq, tk, 64, 1)     # keys owned
            kb0 = j // (16 * g.wq) * 16 * g.wq
            kw = j % (16 * g.wq) // 16 * 16
            walked = i < -(-tq // g.kt) * g.kt
            if causal:
                walked &= (i // g.kt >= kb0 // g.kt) & (i // 16 * 16 + 15
                                                        >= kb0 + kw)
            assert walked[vis].all(), ("dkdv", tq, tk)
            for kernel in ("dq", "fwd"):                # queries owned
                g = tfa.mma_geom(kernel, tq, tk, 64, 1)
                qlast = np.minimum(tq, i // (16 * g.wq) * 16 * g.wq
                                   + 16 * g.wq) - 1
                r0 = i // 16 * 16
                walked = j < -(-tk // g.kt) * g.kt
                if causal:
                    walked &= (j // g.kt <= qlast // g.kt) & (j // 16 * 16
                                                              <= r0 + 15)
                assert walked[vis].all(), (kernel, tq, tk)


def test_bwd_geom_fits_shared_memory():
    """For Tq and Tk in 1-130 and every head dim, the three kernels' tiles
    fit: whole 16-row steps up to 64, a head dim padded to 16 in rows of
    dp + 8, stages that hold the walked rows, a second stage where the
    walked length spans more than one tile, the fixed rows (dK/dV's K and
    V, the forward's f32 q), and a block that fits twice on an SM (so
    within the 232,448 bytes a block may take)."""
    worst = 0
    budget = tfa.SM_SMEM // 2 - tfa.BLOCK_RESERVED
    for kernel in tfa.MMA_KERNELS:
        dkdv = kernel == "dkdv"
        for tq in range(1, 131):
            for tk in range(1, 131):
                walked = tq if dkdv else tk
                for d in GEOM_DIMS:
                    g = tfa.mma_geom(kernel, tq, tk, d, 5)
                    tile = g.kt * g.lds * 2
                    need = 2 * tile + (3 * g.kt * 4 if dkdv else g.kt)
                    assert g.kt % 16 == 0 and 16 <= g.kt <= min(
                        -(-walked // 16) * 16, 64)
                    assert g.dp % 16 == 0 and d <= g.dp < d + 16
                    assert g.lds == g.dp + 8 and g.stage % 16 == 0
                    assert need <= g.stage < need + 16
                    assert g.nst == (2 if walked > g.kt else 1)
                    own = 16 * g.wq
                    assert g.fixed == {"dkdv": 2 * own * g.lds * 2,
                                       "fwd": own * (g.dp + 4) * 4,
                                       "dq": 0}[kernel]
                    assert g.smem == g.groups * (g.fixed + g.nst * g.stage)
                    worst = max(worst, g.smem)
    assert worst <= budget <= 232_448   # what a block may take on sm_90


@pytest.mark.parametrize("tq,tk", TRAIN_SHAPES)
def test_bwd_geom_training_shapes(tq, tk):
    """At the flagship's training shapes (B*H 512, Dh 128) 2 or more
    blocks of each kernel share an SM, and a call fits in one wave of the
    card's 132 SMs; 21 x 21 takes 256 blocks, 3 x 3 128.  The forward walks
    one key tile, so it makes one pass over K and V."""
    for kernel in tfa.MMA_KERNELS:
        g = tfa.mma_geom(kernel, tq, tk, 128, 512)
        per_sm = tfa.SM_SMEM // (g.smem + tfa.BLOCK_RESERVED)
        assert per_sm >= 2, (kernel, g.smem)
        assert g.grid_x * g.grid_y <= 132 * 2
        if (tq, tk) == (21, 21):
            assert g.grid_x * g.grid_y == 256
        if (tq, tk) == (3, 3):
            assert g.grid_x * g.grid_y == 128
    g = tfa.mma_geom("fwd", tq, tk, 128, 512)
    assert g.nst == 1 and g.kt >= tk


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_args_hand_the_forward_its_tiling(dtype):
    """``_args`` gives a bf16 forward launch the forward's tiling (the dQ
    kernel's walk of the keys, with the group's q rows in f32 as its fixed
    bytes) and an f32 one an empty tiling, which the FMA kernel does not
    read."""
    q, k, v, kv_pad, _ = _inputs(3, 20, 45, 2, 80, seed=2, pad="tail")
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    call = tfa._args(q, k, v, torch.from_numpy(kv_pad), True, "fwd")
    fields = [f for f, _ in call.geom._fields_]
    got = [getattr(call.geom, f) for f in fields]
    if dtype == torch.bfloat16:
        want = tfa.mma_geom("fwd", 20, 45, 80, 6)
        assert got == [getattr(want, f) for f in fields]
        dq = tfa.mma_geom("dq", 20, 45, 80, 6)
        for f in fields:
            if f not in ("fixed", "smem"):
                assert getattr(call.geom, f) == getattr(dq, f), f
        assert (call.geom.wq, call.geom.groups, call.geom.kt,
                call.geom.dp, call.geom.nst) == (2, 2, 48, 80, 1)
        assert call.geom.fixed == 32 * (80 + 4) * 4
        assert call.geom.smem == 2 * (call.geom.fixed + call.geom.stage)
    else:
        assert got == [0] * len(fields)
    assert (call.a.act_bf16, call.a.causal, call.a.tq, call.a.tk,
            call.a.dim) == (int(dtype == torch.bfloat16), 1, 20, 45, 80)


def test_flash_args_layout():
    """``FlashCall`` mirrors the C struct: ``FlashArgs`` (ints 4 bytes,
    pointers 8, each aligned to its size; 128 bytes, the FMA kernels'
    parameter), then the 11 ints of ``FlashGeom``."""
    import ctypes

    from blt_vqg_tpu_torch.ops.kernels import _build

    ints = ("act_bf16", "causal", "batch", "heads", "tq", "tk", "dim")
    ptrs = ("q", "k", "v", "kv_pad", "o", "m", "l", "dout", "delta", "dq",
            "dk", "dv")
    assert [getattr(_build.FlashArgs, f).offset for f in ints] == [
        4 * n for n in range(7)]
    assert [getattr(_build.FlashArgs, f).offset for f in ptrs] == [
        32 + 8 * n for n in range(12)]
    assert ctypes.sizeof(_build.FlashArgs) == 128
    assert _build.FlashCall.a.offset == 0
    assert _build.FlashCall.geom.offset == 128
    assert [f for f, _ in _build.FlashGeom._fields_] == [
        "wq", "groups", "kt", "dp", "lds", "fixed", "stage", "nst", "smem",
        "grid_x", "grid_y"]
    assert ctypes.sizeof(_build.FlashGeom) == 44
    assert ctypes.sizeof(_build.FlashCall) == 176
