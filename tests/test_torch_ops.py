"""The port's leaf modules against the JAX package's, on the same weights
and numpy inputs, in f32 at tiny sizes.

Weights are made in the port from a seed and carried to flax with
``convert.to_flax``; each module then runs in both packages.  Tolerance:
1e-5 absolute and relative (the two differ in the order of f32 sums and in
the library's sin/cos/exp).  Masks must be equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.ops import attention as jatt
from blt_vqg_tpu.ops import latent as jlat
from blt_vqg_tpu.ops import masks as jmasks
from blt_vqg_tpu.ops import mlp as jmlp
from blt_vqg_tpu.ops import resnet as jres
from blt_vqg_tpu.ops import timing as jtiming
from blt_vqg_tpu.ops import transformer as jtr
from blt_vqg_tpu_torch.convert import to_flax
from blt_vqg_tpu_torch.ops import attention, latent, masks, mlp, resnet
from blt_vqg_tpu_torch.ops import timing, transformer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = torch.float32
D, H, FFN, B = 32, 4, 64, 3
TOL = dict(atol=1e-5, rtol=1e-5)


def _randomize(module, seed):
    """Seeded weights at unit-preserving scales; norm scales near 1, small
    biases, positive running variances."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda shape: torch.randn(shape, generator=g)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1:
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.1 * rn(p.shape))
            else:
                p.copy_(rn(p.shape) / math.sqrt(p[0].numel()))
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * rn(buf.shape))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return module.eval()


def _flax(module):
    params, stats = to_flax(module.state_dict())
    return {"params": params, "batch_stats": stats} if stats else {
        "params": params}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("length,channels", [(5, 32), (51, 1024), (7, 33),
                                             (1, 2)])
def test_timing_signal(length, channels):
    _close(timing.timing_signal(length, channels),
           jtiming.timing_signal(length, channels))


def test_masks_equal():
    tokens = np.array([[1, 5, 0, 0], [0, 2, 3, 0]], np.int32)
    np.testing.assert_array_equal(
        masks.pad_mask(torch.from_numpy(tokens)).numpy(),
        np.asarray(jmasks.pad_mask(jnp.asarray(tokens))))
    np.testing.assert_array_equal(masks.causal_mask(5).numpy(),
                                  np.asarray(jmasks.causal_mask(5)))
    assert masks.MASK_FILL == jmasks.MASK_FILL


def test_mlp():
    port = _randomize(mlp.MLP(D, FFN, D, num_layers=2, dtype=F32), 0)
    x = _np(1, B, D)
    want = jmlp.MLP(FFN, D, num_layers=2, dtype=jnp.float32).apply(
        _flax(port), x)
    _close(port(torch.from_numpy(x)), want)


@pytest.mark.parametrize("use_posterior", [False, True])
@pytest.mark.parametrize("use_mean", [False, True])
def test_latent(monkeypatch, use_posterior, use_mean):
    lat = 24
    port = _randomize(latent.Latent(D, lat, F32), 2)
    x, x_p = _np(3, B, D), _np(4, B, D)
    eps = _np(5, B, lat)
    # the JAX module draws eps from its RNG stream; both get the same eps
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(eps))
    kld_j, z_j, (mq_j, lq_j) = jlat.Latent(lat, dtype=jnp.float32).apply(
        _flax(port), x, x_p if use_posterior else None, use_mean=use_mean,
        rngs={"latent": jax.random.key(0)})
    kld, z, (mq, lq) = port(torch.from_numpy(x),
                            torch.from_numpy(x_p) if use_posterior else None,
                            eps=torch.from_numpy(eps), use_mean=use_mean)
    _close(kld, kld_j)
    _close(z, z_j)
    if use_posterior:
        _close(mq, mq_j)
        _close(lq, lq_j)
    else:
        assert mq is None and mq_j is None


def _mha(causal, seed):
    port = _randomize(attention.MultiHeadAttention(D, H, F32, causal=causal),
                      seed)
    jmod = jatt.MultiHeadAttention(D, H, dropout_rate=0.0,
                                   dtype=jnp.float32, causal=causal)
    return port, jmod, _flax(port)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_call(causal):
    port, jmod, v = _mha(causal, 6)
    q, kv = _np(7, B, 5, D), _np(8, B, 5 if causal else 3, D)
    mask = np.zeros((B, 1, 1, kv.shape[1]), bool)
    mask[1, ..., -1] = True
    want = jmod.apply(v, q, kv, jnp.asarray(mask))
    got = port(torch.from_numpy(q), torch.from_numpy(kv),
               torch.from_numpy(mask))
    _close(got, want)


def test_mha_kv_and_attend_cached():
    port, jmod, v = _mha(False, 9)
    enc, q = _np(10, B, 3, D), _np(11, B, 1, D)
    k_j, v_j = jmod.apply(v, enc, method=jatt.MultiHeadAttention.kv)
    k, vv = port.kv(torch.from_numpy(enc))
    _close(k, k_j)
    _close(vv, v_j)
    mask = np.zeros((B, 1, 1, 3), bool)
    mask[0, ..., 2] = True
    want = jmod.apply(v, q, k_j, v_j, jnp.asarray(mask),
                      method=jatt.MultiHeadAttention.attend_cached)
    _close(port.attend_cached(torch.from_numpy(q), k, vv,
                              torch.from_numpy(mask)), want)


@pytest.mark.parametrize("with_key_pad", [False, True])
def test_mha_step(with_key_pad):
    port, jmod, v = _mha(True, 12)
    lmax = 4
    ck = cv = jnp.zeros((B, lmax, H, D // H), jnp.float32)
    pk = torch.zeros((B, lmax, H, D // H))
    pv = torch.zeros((B, lmax, H, D // H))
    key_pad = np.zeros((B, lmax), bool)
    # one compiled JAX step for every position (pos is an array)
    jstep = jax.jit(lambda *a: jmod.apply(
        v, *a, method=jatt.MultiHeadAttention.step))
    for pos in range(lmax):
        x = _np(13 + pos, B, 1, D)
        key_pad[0, pos] = pos == 0          # a <pad> seed on row 0
        kp = key_pad if with_key_pad else None
        out_j, ck, cv = jstep(x, ck, cv, jnp.asarray(pos),
                              None if kp is None else jnp.asarray(kp))
        out, pk, pv = port.step(torch.from_numpy(x), pk, pv, pos,
                                None if kp is None else torch.from_numpy(kp))
        _close(out, out_j)
    _close(pk, ck)
    _close(pv, cv)


def test_transformer_encoder():
    port = _randomize(transformer.TransformerEncoder(D, 2, H, FFN, F32), 20)
    x = _np(21, B, 5, D)
    tokens = np.array([[1, 4, 3, 0, 0], [1, 2, 2, 2, 3], [1, 0, 0, 0, 0]])
    mask = tokens == 0
    want = jtr.TransformerEncoder(D, 2, H, FFN, attention_dropout=0.0,
                                  relu_dropout=0.0, dtype=jnp.float32).apply(
        _flax(port), x, jnp.asarray(mask[:, None, None, :]))
    got = port(torch.from_numpy(x), torch.from_numpy(mask[:, None, None, :]))
    _close(got, want)


@pytest.mark.parametrize("with_key_pad", [False, True])
def test_decoder_plain_steps(with_key_pad):
    lmax, tc = 5, 3
    port = _randomize(transformer.TransformerDecoder(
        D, 2, H, FFN, F32, max_decode_len=lmax), 22)
    jdec = jtr.TransformerDecoder(D, 2, H, FFN, attention_dropout=0.0,
                                  relu_dropout=0.0, dtype=jnp.float32,
                                  max_decode_len=lmax)
    v = _flax(port)
    enc = _np(23, B, tc, D)
    src = np.zeros((B, 1, 1, tc), bool)
    src[2, ..., 1:] = True
    cross_j = jdec.apply(v, enc, method=jtr.TransformerDecoder.precompute_cross)
    caches_j = jdec.apply(v, B, lmax, method=jtr.TransformerDecoder.init_cache)
    cross = port.precompute_cross(torch.from_numpy(enc))
    for (k, vv), (kj, vj) in zip(cross, cross_j):
        _close(k, kj)
        _close(vv, vj)
    caches = port.init_cache(B, lmax)
    key_pad = np.zeros((B, lmax), bool)
    # one compiled JAX step for every position (pos is an array)
    jstep = jax.jit(lambda *a: jdec.apply(
        v, *a, method=jtr.TransformerDecoder.step))
    for pos in range(lmax):
        x = _np(24 + pos, B, 1, D)
        key_pad[1, pos] = pos in (0, 2)
        kp = key_pad if with_key_pad else None
        y_j, caches_j = jstep(x, caches_j, cross_j, jnp.asarray(pos),
                              jnp.asarray(src),
                              None if kp is None else jnp.asarray(kp))
        y, caches = port.step(torch.from_numpy(x), caches, cross, pos,
                              torch.from_numpy(src),
                              None if kp is None else torch.from_numpy(kp))
        _close(y, y_j)
    for (k, vv), (kj, vj) in zip(caches, caches_j):
        _close(k, kj)
        _close(vv, vj)


def test_encoder_cnn_nhwc_eval():
    port = _randomize(resnet.EncoderCNN(D, F32), 30)
    images = np.random.RandomState(31).rand(2, 32, 32, 3).astype(np.float32)
    # compiled as one program: cheaper than the eager ResNet
    want = jax.jit(lambda v, im: jres.EncoderCNN(D, dtype=jnp.float32).apply(
        v, im, train=False))(_flax(port), images)
    _close(port(torch.from_numpy(images)), want)
