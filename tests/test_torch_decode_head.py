"""The port's fused decode head against the JAX package's.

``head_argmax_ref`` (the plain PyTorch version of the CUDA kernel) must pick
the same tokens as the JAX ``head_argmax`` (its Pallas kernel in interpret
mode) on the same numpy inputs, in the f32 and int8 forms, with ties going
to the first index and padded columns never winning.  Tokens must be
exactly equal; the inputs are checked to have a top-2 logit gap above 1e-3
so that the order of f32 sums cannot decide a token.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.ops.pallas import decode_head as jdh
from blt_vqg_tpu.ops.pallas.decode_stream import quantize_stack as jax_quant
from blt_vqg_tpu_torch.ops.kernels import decode_head as tdh
from blt_vqg_tpu_torch.ops.kernels.decode_stream import quantize_stack


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab,target", [(12000, 1024), (50, 1024),
                                          (300, 1024), (4096, 1024),
                                          (700, 256)])
def test_head_chunk_equal(vocab, target):
    assert tdh.head_chunk(vocab, target) == jdh.head_chunk(vocab, target)


@pytest.mark.parametrize("v,chunk", [(300, 128), (256, 128), (50, 128)])
def test_pad_head_equal(v, chunk):
    r = np.random.RandomState(v)
    w = r.randn(8, v).astype(np.float32)
    b = r.randn(v).astype(np.float32)
    wj, bj = jdh.pad_head(jnp.asarray(w), jnp.asarray(b), chunk)
    wt, bt = tdh.pad_head(torch.from_numpy(w), torch.from_numpy(b), chunk)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def _inputs(v, d=32, bsz=6, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(bsz, d) * 3.0).astype(np.float32)
    scale = (1.0 + 0.1 * r.randn(d)).astype(np.float32)
    bias = (0.1 * r.randn(d)).astype(np.float32)
    w = r.randn(d, v).astype(np.float32)
    b = r.randn(v).astype(np.float32)
    return x, scale, bias, w, b


def _both(x, scale, bias, w, b, chunk, scales=None):
    """(JAX tokens, port tokens, port logits) on the same inputs."""
    conv = lambda a: None if a is None else jnp.asarray(a)
    want = jdh.head_argmax(conv(x), conv(scale), conv(bias), conv(w),
                           conv(b), chunk=chunk, scales=conv(scales))
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    before = tdh.head_argmax.launches
    got = tdh.head_argmax(t(x), t(scale), t(bias), t(w), t(b), chunk=chunk,
                          scales=t(scales))
    assert tdh.head_argmax.launches == before   # CPU: plain version
    ref = tdh.head_argmax_ref(t(x), t(scale), t(bias), t(w), t(b),
                              scales=t(scales))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    logits = tdh.head_logits_ref(t(x), t(scale), t(bias), t(w), t(b),
                                 t(scales))
    return np.asarray(want), got, logits


def _assert_clear_top2(logits):
    top2 = logits.topk(2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3


@pytest.mark.parametrize("v", [50, 300, 1024, 2500])
def test_f32_matches_jax(v):
    x, scale, bias, w, b = _inputs(v, seed=v)
    chunk = jdh.head_chunk(v, target=256)
    wp, bp = tdh.pad_head(torch.from_numpy(w), torch.from_numpy(b), chunk)
    want, got, logits = _both(x, scale, bias, wp.numpy(), bp.numpy(), chunk)
    _assert_clear_top2(logits)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("v,seed", [(700, 7), (12000, 6)])
def test_int8_matches_jax(v, seed):
    x, scale, bias, w, b = _inputs(v, seed=seed)
    w8, s = quantize_stack(torch.from_numpy(w))
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jax_quant(w)[0]))
    chunk = tdh.head_chunk(v)
    wp, bp = tdh.pad_head(w8, torch.from_numpy(b), chunk)
    sp = torch.nn.functional.pad(s, (0, wp.shape[1] - v), value=1.0)
    want, got, logits = _both(x, scale, bias, wp.numpy(), bp.numpy(), chunk,
                              sp.numpy())
    _assert_clear_top2(logits)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ties_go_to_first_index():
    d, v, chunk = 16, 512, 128
    r = np.random.RandomState(3)
    w = r.randn(d, v).astype(np.float32)
    # column 5 == column 40 (same chunk), column 9 == column 200 (another
    # chunk); a large shared bias makes them the maxima
    w[:, 40] = w[:, 5]
    w[:, 200] = w[:, 9]
    b = np.full((v,), -10.0, np.float32)
    b[[5, 40]] = 50.0
    b[[9, 200]] = 60.0
    x = r.randn(3, d).astype(np.float32)
    want, got, _ = _both(x, np.ones(d, np.float32), np.zeros(d, np.float32),
                         w, b, chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), 9)


def test_padded_columns_never_win():
    v = 130                                   # pads to 256
    x, scale, bias, w, b = _inputs(v, seed=11)
    wp, bp = tdh.pad_head(torch.from_numpy(w), torch.from_numpy(b - 1e6),
                          256)
    want, got, _ = _both(x, scale, bias, wp.numpy(), bp.numpy(), 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < v
