"""The port's RNN model family (``ops/rnn.py``, ``models/iq_rnn.py``)
against the JAX package, for LSTM and GRU cells.

- ``RNNEncoder`` (the stack's outputs and each row's output at its last
  non-pad token) and ``RNNDecoder.teacher_forced`` at 2 layers;
- ``IQRNN`` in train mode in both phases (logits, z_logit, kld, features
  and reconstruction), and one latent train step (parameters, moments and
  metrics);
- greedy tokens of ``IQRNN.decode_greedy`` in the latent phase (the
  prior z injected), equal, with the JAX prior noise injected; and
  ``make_decode_step`` (which gives the model only the keywords its
  ``decode_greedy`` takes) returns the model's own pretrain-phase tokens.

Tolerance: 1e-5 of each tensor's scale, 2e-3 for what is computed from the
train-mode image features (tests/test_torch_train.py).  Weights are made in
the port from a seed and carried to flax with ``convert.to_flax``; f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq_rnn import IQRNN as JaxIQRNN
from blt_vqg_tpu.ops import rnn as jrnn
from blt_vqg_tpu.train.schedule import noam_schedule as jax_noam
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import make_optimizer
from blt_vqg_tpu.train.step import make_train_step as jax_make_train_step
from blt_vqg_tpu_torch.convert import from_flax, to_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq_rnn import IQRNN
from blt_vqg_tpu_torch.ops import rnn
from blt_vqg_tpu_torch.ops.layers import init_weights_
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import (make_batch, make_decode_step,
                                          make_train_step)
from test_torch_moe import perturbed
from test_torch_train import FEATURE_TOL, TINY, TOL, VOCAB, assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH, SEED = 4, 17
CELLS = ["lstm", "gru"]


def _perturb_biases(module, seed):
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(0.1 * r.randn(*p.shape).astype(
                    np.float32)))
    return module


@pytest.mark.parametrize("cell", CELLS)
def test_rnn_encoder_and_decoder_match_jax(cell):
    v, e, h, layers = 30, 12, 16, 2
    r = np.random.RandomState(1)
    tokens = r.randint(1, v, (3, 7)).astype(np.int32)
    tokens[0, 4:] = 0
    tokens[2, 1:] = 0
    enc = _perturb_biases(init_weights_(
        rnn.RNNEncoder(v, e, h, layers, cell),
        torch.Generator().manual_seed(2)), 3)
    params, _ = to_flax(enc.state_dict())
    ys, final = jax.jit(lambda p: jrnn.RNNEncoder(
        v, e, h, layers, cell, jnp.float32).apply({"params": p}, tokens))(
            params)
    got_ys, got_final = enc(torch.from_numpy(tokens))
    assert_close(got_ys.detach(), ys, TOL, "encoder outputs")
    assert_close(got_final.detach(), final, TOL, "encoder final")

    dec = _perturb_biases(init_weights_(
        rnn.RNNDecoder(v, e, h, layers, cell),
        torch.Generator().manual_seed(4)), 5)
    params, _ = to_flax(dec.state_dict())
    ctx = r.randn(3, h).astype(np.float32)
    want = jax.jit(lambda p: jrnn.RNNDecoder(
        v, e, h, layers, cell, jnp.float32).apply(
            {"params": p}, tokens, ctx,
            method=jrnn.RNNDecoder.teacher_forced))(params)
    got = dec.teacher_forced(torch.from_numpy(tokens), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    assert_close(got.detach(), want, TOL, "decoder logits")


_SETUPS = {}


def _setup(cell):
    if cell not in _SETUPS:
        cfg = Config(**TINY, model_family="rnn", rnn_cell=cell)
        weights = perturbed(IQRNN(cfg, VOCAB), SEED)
        params, stats = to_flax(weights)
        batch = make_batch(cfg, VOCAB, BATCH, np.random.RandomState(SEED),
                           device="cpu")
        _SETUPS[cell] = {
            "weights": weights, "batch": batch,
            "variables": {"params": params, "batch_stats": stats},
            "np_batch": {k: v.numpy() for k, v in batch.items()}}
    return _SETUPS[cell]


def _cfgs(cell):
    over = dict(model_family="rnn", rnn_cell=cell)
    return JaxConfig(**TINY, **over), Config(**TINY, **over)


def _port(cell, weights):
    model = IQRNN(_cfgs(cell)[1], VOCAB)
    model.load_state_dict(weights)
    return model


def _jax_eps(variables, cfg, key):
    """The noise the JAX ``latent`` module draws under ``key``."""
    draw = lambda m: jax.random.normal(m.latent.make_rng("latent"),
                                       (BATCH, cfg.latent_dim), jnp.float32)
    return torch.from_numpy(np.array(JaxIQRNN(cfg, VOCAB).apply(
        variables, method=draw, rngs={"latent": key})))


@pytest.mark.parametrize("cell", CELLS)
def test_iq_rnn_forward_matches_jax(cell):
    s = _setup(cell)
    jcfg, _ = _cfgs(cell)
    key = jax.random.key(7)
    b = s["np_batch"]
    fwd = jax.jit(lambda v, latent_mode: JaxIQRNN(jcfg, VOCAB).apply(
        v, b["images"], b["context"], b["posterior"], b["target"],
        latent_mode=latent_mode, train=True, rngs={"latent": key},
        mutable=["batch_stats"]), static_argnums=1)
    eps = _jax_eps(s["variables"], jcfg, key)
    model = _port(cell, s["weights"])
    tb = s["batch"]
    for latent_mode in (False, True):
        (w_logits, w_z, w_kld, (w_feat, w_recon)), _ = fwd(s["variables"],
                                                           latent_mode)
        with torch.no_grad():
            logits, z_logit, kld, (feat, recon) = model(
                tb["images"], tb["context"], tb["posterior"], tb["target"],
                latent_mode=latent_mode, train=True, eps=eps)
        what = f"latent {latent_mode}"
        assert_close(logits, w_logits, TOL, f"{what}: logits")
        assert_close(kld, w_kld, TOL, f"{what}: kld")
        assert_close(feat, w_feat, FEATURE_TOL, f"{what}: features")
        assert_close(recon, w_recon, TOL, f"{what}: recon")
        if latent_mode:
            assert_close(z_logit, w_z, FEATURE_TOL, f"{what}: z_logit")
        else:
            assert z_logit is None and w_z is None


@pytest.mark.parametrize("cell", CELLS)
def test_iq_rnn_train_step_matches_jax(cell):
    s = _setup(cell)
    jcfg, pcfg = _cfgs(cell)
    params = jax.tree_util.tree_map(jnp.asarray, s["variables"]["params"])
    tx = make_optimizer(jcfg, params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), kliter=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           s["variables"]["batch_stats"]),
        opt_state=tx.init(params), tx=tx,
        apply_fn=JaxIQRNN(jcfg, VOCAB).apply,
        lr_fn=jax_noam(jcfg.hidden_dim, jcfg.warmup_steps))
    rng = jax.random.key(9)
    jstate, jmetrics = jax_make_train_step(jcfg, True)(jstate, s["np_batch"],
                                                       rng)
    state = create_train_state(pcfg, _port(cell, s["weights"]), seed=None)
    eps = _jax_eps(s["variables"], jcfg, jax.random.fold_in(rng, 0))
    state, metrics = make_train_step(pcfg, True)(
        state, s["batch"], torch.Generator().manual_seed(0), eps=eps)
    assert set(metrics) == set(jmetrics)
    for name, value in metrics.items():
        tol = FEATURE_TOL if name == "img" else TOL
        assert_close(value, np.asarray(jmetrics[name]), tol, name)
    want = from_flax(jax.tree_util.tree_map(np.asarray, jstate.params),
                     jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        tol = FEATURE_TOL if name.startswith("encoder_cnn.") else TOL
        assert_close(got[name], w, tol, name)


@pytest.mark.parametrize("cell", CELLS)
def test_iq_rnn_greedy_tokens_match_jax(cell):
    s = _setup(cell)
    jcfg, pcfg = _cfgs(cell)
    images, context = s["np_batch"]["images"], s["np_batch"]["context"]
    key = jax.random.key(11)
    want = jax.jit(lambda v: JaxIQRNN(jcfg, VOCAB).apply(
        v, images, context, max_decode_length=jcfg.max_decode_length,
        latent_mode=True, method=JaxIQRNN.decode_greedy,
        rngs={"latent": key}))(s["variables"])
    model = _port(cell, s["weights"]).eval()
    eps = _jax_eps(s["variables"], jcfg, key)
    ti, tc = torch.from_numpy(images), torch.from_numpy(context)
    with torch.inference_mode():
        got = model.decode_greedy(ti, tc, jcfg.max_decode_length, True,
                                  eps=eps)["tokens"]
        plain = model.decode_greedy(ti, tc, jcfg.max_decode_length)
    assert got.shape == (BATCH, jcfg.max_decode_length + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["tokens"]))
    # the decode step passes only what IQRNN.decode_greedy takes
    step = make_decode_step(pcfg, model, latent_mode=False)
    got = step(ti, tc, torch.Generator().manual_seed(0),
               torch.Generator().manual_seed(1))
    assert torch.equal(got["tokens"], plain["tokens"])
