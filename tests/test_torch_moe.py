"""The port's mixture-of-experts FFN (``ops/moe.py``) and its MoE model
against the JAX package.

- ``route_tokens``: dispatch equal exactly and combine within 1e-6, at
  top-1 and top-2, with capacities that overflow, rows whose top
  probabilities tie (the lower expert first, as ``jax.lax.top_k``) and a
  popular expert whose second choices must wait for every first choice;
  ``expert_capacity`` at decode and training token counts.
- ``MoEFeedForward`` (relu and gelu) and its balance and router-z losses;
  the IQ forward in train mode (latent phase) with its losses, and one
  pretrain step (``moe_every`` 2: the second layer of each stack is MoE;
  the step's program is the smaller phase's), within 1e-5 of
  each tensor's scale (2e-3 where a value comes from the train-mode image
  features, see tests/test_torch_train.py); greedy tokens on the plain
  decode path equal.
- The per-layer and streaming decode paths refuse MoE, with the JAX
  package's words.

Weights are made in the port from a seed (norm parameters and biases
perturbed from numpy) and carried to flax with ``convert.to_flax``; f32,
every dropout 0, the JAX posterior noise injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.ops import moe as jmoe
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import make_optimizer
from blt_vqg_tpu.train.schedule import noam_schedule as jax_noam
from blt_vqg_tpu.train.step import _collect_moe_losses
from blt_vqg_tpu.train.step import make_train_step as jax_make_train_step
from blt_vqg_tpu_torch.convert import from_flax, to_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.ops import moe
from blt_vqg_tpu_torch.parallel import build_mesh
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import (collect_moe_losses, make_batch,
                                          make_train_step)
from test_torch_train import (FEATURE_TOL, TINY, TOL, VOCAB, assert_close,
                              jax_eps)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH, SEED = 4, 11
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.75,
           moe_every=2)


def perturbed(model: torch.nn.Module, seed: int) -> dict:
    """The model's seed-made weights with its norm parameters, biases and
    batch-norm statistics perturbed, so that every leaf matters, and
    ``feat_bn`` scaled down (tests/test_torch_train.py); a state dict."""
    model.init_weights(torch.Generator().manual_seed(seed))
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 or name.endswith("_bias"):
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(torch.from_numpy(
                    base + 0.1 * r.randn(*p.shape).astype(np.float32)))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    0.1 * r.randn(*buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(
                    (0.5 + r.rand(*buf.shape)).astype(np.float32)))
        model.encoder_cnn.feat_bn.weight.mul_(0.01)
    return {n: t.clone() for n, t in model.state_dict().items()}


# ---------------------------------------------------------------------------
def _probs(r, s, e):
    logits = r.randn(s, e).astype(np.float32)
    logits[3] = logits[3, 0]                 # a four-way tie
    logits[5, 1] = logits[5, 2]              # a tie at the top two
    logits[5, 1:3] += 10.0
    logits[7:, 2] += 3.0                     # a popular first choice
    return jax.nn.softmax(jnp.asarray(logits), axis=-1)


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 4), (2, 13), (3, 2)])
def test_route_tokens_matches_jax(k, capacity):
    probs = np.array(_probs(np.random.RandomState(k + capacity), 13, 4))
    jd, jc = jmoe.route_tokens(jnp.asarray(probs), k, capacity)
    d, c = moe.route_tokens(torch.from_numpy(probs), k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    if capacity < 13:
        assert float(d.sum()) < 13 * k, "the capacity should overflow"
    for s in (4, 13, 40, 64):
        assert moe.expert_capacity(s, 4, k, 1.25) == jmoe.expert_capacity(
            s, 4, k, 1.25)
    top1 = torch.argmax(torch.from_numpy(probs), dim=-1)
    assert_close(moe.balance_loss(torch.from_numpy(probs), top1),
                 jmoe.balance_loss(jnp.asarray(probs), jnp.asarray(top1)),
                 1e-6, "balance")


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_moe_feed_forward_matches_jax(activation):
    d, f, e = 16, 24, 4
    layer = moe.MoEFeedForward(d, f, e, top_k=2, capacity_factor=1.0,
                               dropout_rate=0.0, dtype=torch.float32,
                               activation=activation)
    layer.seed_init(torch.Generator().manual_seed(3))
    r = np.random.RandomState(4)
    with torch.no_grad():
        for b in (layer.expert_in_bias, layer.expert_out_bias):
            b.copy_(torch.from_numpy(0.1 * r.randn(*b.shape).astype(
                np.float32)))
        layer.router.mul_(20.0)      # peaked routing: drops at capacity 1.0
    x = r.randn(3, 7, d).astype(np.float32)
    params = {n: p.detach().numpy() for n, p in layer.named_parameters()}
    jlayer = jmoe.MoEFeedForward(d, f, e, top_k=2, capacity_factor=1.0,
                                 dropout_rate=0.0, dtype=jnp.float32,
                                 activation=activation)
    want, sown = jax.jit(lambda p: jlayer.apply(
        {"params": p}, x, deterministic=True, mutable=["moe"]))(params)
    aux = []
    got = layer(torch.from_numpy(x), aux=aux)
    assert_close(got.detach(), want, TOL, "y")
    (balance, router_z), = aux
    assert_close(balance.detach(), sown["moe"]["balance"][0], TOL, "balance")
    assert_close(router_z.detach(), sown["moe"]["router_z"][0], TOL,
                 "router_z")


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_setup():
    weights = perturbed(IQ(Config(**TINY, **MOE), VOCAB), SEED)
    params, stats = to_flax(weights)
    batch = make_batch(Config(**TINY), VOCAB, BATCH,
                       np.random.RandomState(SEED), device="cpu")
    return {"weights": weights, "variables": {"params": params,
                                              "batch_stats": stats},
            "batch": batch,
            "np_batch": {k: v.numpy() for k, v in batch.items()}}


def _port(weights, **over):
    model = IQ(Config(**TINY, **MOE, **over), VOCAB)
    model.load_state_dict(weights)
    return model


def test_moe_layers_and_refusals(moe_setup):
    """MoE on the last layer of each group of ``moe_every``; the JAX tree
    holds the same leaves; the kernel decode paths refuse MoE."""
    model = _port(moe_setup["weights"])
    for stack in (model.context_encoder, model.posterior_encoder,
                  model.decoder):
        kinds = [type(layer.ffn).__name__ for layer in stack.layers]
        assert kinds == ["PositionwiseFeedForward", "MoEFeedForward"]
    shapes = jax.eval_shape(
        lambda: JaxIQ(JaxConfig(**TINY, **MOE), VOCAB).init(
            {"params": jax.random.key(0), "latent": jax.random.key(1),
             "dropout": jax.random.key(2)}, *(moe_setup["np_batch"][k] for k in
                                              ("images", "context",
                                               "posterior", "target")),
            latent_mode=True))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   shapes)
    want = from_flax(zeros["params"], zeros["batch_stats"])
    assert {n: tuple(t.shape) for n, t in want.items()} == {
        n: tuple(t.shape) for n, t in moe_setup["weights"].items()}
    with pytest.raises(ValueError, match="fused Pallas decode path"):
        IQ(Config(**TINY, **MOE, use_pallas_decode=True), VOCAB)
    with pytest.raises(ValueError, match="streaming decode path"):
        IQ(Config(**TINY, **MOE, use_stream_decode=True), VOCAB)
    with pytest.raises(ValueError, match="MoE \\+ GPipe"):
        IQ(Config(**TINY, **MOE, pipeline_stages=2), VOCAB)
    # an expert axis spans processes: without a process group it refuses
    with pytest.raises(RuntimeError, match="not initialised"):
        build_mesh((2,), ("expert",), device="cpu")


def test_moe_forward_and_losses_match_jax(moe_setup):
    cfg = JaxConfig(**TINY, **MOE)
    key = jax.random.key(21)
    s = moe_setup
    model = JaxIQ(cfg, VOCAB)
    b = s["np_batch"]
    (outs, upd) = jax.jit(lambda v: model.apply(
        v, b["images"], b["context"], b["posterior"], b["target"],
        latent_mode=True, train=True,
        rngs={"latent": key, "dropout": jax.random.fold_in(key, 1)},
        mutable=["batch_stats", "moe"]))(s["variables"])
    balance, router_z = _collect_moe_losses(upd["moe"])

    port = _port(s["weights"])
    eps = torch.from_numpy(jax_eps(s["variables"], cfg, key))
    losses = []
    tb = s["batch"]
    got = port(tb["images"], tb["context"], tb["posterior"], tb["target"],
               latent_mode=True, train=True,
               generator=torch.Generator().manual_seed(0), eps=eps,
               moe_losses=losses)
    assert len(losses) == 3     # one MoE layer in each of the three stacks
    logits, z_logit, kld, (feat, recon) = got
    w_logits, w_z, w_kld, (w_feat, w_recon) = outs
    assert_close(logits.detach(), w_logits, TOL, "logits")
    assert_close(z_logit.detach(), w_z, FEATURE_TOL, "z_logit")
    assert_close(kld.detach(), w_kld, TOL, "kld")
    assert_close(recon.detach(), w_recon, TOL, "recon")
    bal, rz = collect_moe_losses(losses, "cpu")
    assert_close(bal.detach(), balance, TOL, "moe_balance")
    assert_close(rz.detach(), router_z, TOL, "moe_router_z")


def test_moe_train_step_matches_jax(moe_setup):
    cfg = JaxConfig(**TINY, **MOE)
    s = moe_setup
    params = jax.tree_util.tree_map(jnp.asarray, s["variables"]["params"])
    tx = make_optimizer(cfg, params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), kliter=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           s["variables"]["batch_stats"]),
        opt_state=tx.init(params), tx=tx, apply_fn=JaxIQ(cfg, VOCAB).apply,
        lr_fn=jax_noam(cfg.hidden_dim, cfg.warmup_steps))
    jstate, jmetrics = jax_make_train_step(cfg, False)(
        jstate, s["np_batch"], jax.random.key(31))
    pcfg = Config(**TINY, **MOE)
    state = create_train_state(pcfg, _port(s["weights"]), seed=None)
    state, metrics = make_train_step(pcfg, False)(
        state, s["batch"], torch.Generator().manual_seed(0))
    assert set(metrics) == set(jmetrics)
    for name in ("moe_balance", "moe_router_z", "loss", "rec"):
        assert_close(metrics[name], np.asarray(jmetrics[name]), TOL, name)
    assert float(metrics["moe_balance"]) > 0
    want = from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    for name, w in want.items():
        tol = FEATURE_TOL if name.startswith("encoder_cnn.") else TOL
        assert_close(got[name], w, tol, name)


def test_moe_greedy_tokens_match_jax(moe_setup):
    s = moe_setup
    cfg = JaxConfig(**TINY, **MOE)
    kw = dict(latent_mode=True, with_probe=False, z_source="prior_mean")
    images, context = s["np_batch"]["images"], s["np_batch"]["context"]
    want = jax.jit(lambda v: JaxIQ(cfg, VOCAB).apply(
        v, images, context, max_decode_length=cfg.max_decode_length,
        method=JaxIQ.decode_greedy, rngs={"latent": jax.random.key(0)},
        **kw))(s["variables"])
    model = _port(s["weights"]).eval()
    with torch.inference_mode():
        got = model.decode_greedy(torch.from_numpy(images),
                                  torch.from_numpy(context),
                                  max_decode_length=cfg.max_decode_length,
                                  **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
