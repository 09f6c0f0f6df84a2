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
    fn = lambda q, k, v: jflash(q, k, v, None if kv_pad is None
                                else jnp.asarray(kv_pad), causal=causal)
    out, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
    grads = vjp(cast(do))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


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
