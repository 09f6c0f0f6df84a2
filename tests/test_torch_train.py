"""The training slice of the PyTorch port against the JAX package: the
train-mode forward of ``IQ`` in both phases, the losses, the gradient of
every trainable parameter, the eval step, and the port's dropout.

Weights are made in the port from a seed (norm parameters, biases and
batch-norm statistics perturbed from numpy so that every leaf matters) and
carried to flax with ``convert.to_flax``; both packages see the same
numpy-made batch, whose posteriors and targets end in pads.  Every dropout
rate is 0 and the posterior noise the JAX ``latent`` module draws is handed
to the port (the JAX draw is read by applying ``IQ.latent``'s own
``make_rng`` under the same key; the forward match is the proof).  Each
case runs with ``use_pallas_attention`` off (einsum path) and on (the
port's flash Function, plain versions on the CPU; JAX's Pallas kernels in
interpret mode).

Tolerance: 1e-5 of each tensor's largest magnitude (f32; the packages sum
in other orders), except where a value is computed from the train-mode
image features.  Those come out of batch norms over 4 images (1x1 spatial
in the last stage), whose f32 statistics are ill-conditioned: against an
f64 evaluation, JAX's f32 features sit 1.1e-4 away and the port's 8.5e-5.
So the test weights scale ``feat_bn`` down (scale 0.01), which keeps that
error out of every other output, and the features, their reconstruction
loss and the gradients of ``fc``/``feat_bn`` are held to 2e-3.  Gradients
also get an absolute floor of 1e-8 (see ``GRAD_ATOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.train.losses import compute_losses as jax_compute_losses
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import _is_frozen_path, make_optimizer
from blt_vqg_tpu.train.schedule import noam_schedule as jax_noam
from blt_vqg_tpu.train.step import make_eval_step as jax_make_eval_step
from blt_vqg_tpu_torch.convert import from_flax, to_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.ops.layers import dropout
from blt_vqg_tpu_torch.train.losses import compute_losses
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import make_batch, make_eval_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB, BATCH, SEED, KLITER = 50, 4, 3, 2
TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
            num_layers=2, num_heads=4, max_q_length=10, max_a_length=4,
            max_decode_length=8, dtype="float32", image_size=32,
            input_mode="cat", attention_dropout=0.0, relu_dropout=0.0,
            full_kl_step=6, kl_floor=0.5)
TOL, FEATURE_TOL = 1e-5, 2e-3
# a gradient that is zero in exact arithmetic (the fc bias in front of a
# train-mode batch norm) is rounding noise of ~1e-9 on both sides
GRAD_ATOL = 1e-8
# leaves whose gradient is computed from the train-mode image features
FEATURE_LEAVES = ("encoder_cnn.fc.", "encoder_cnn.feat_bn.")
LOSS_ARGS = dict(kl_ceiling=0.5, aux_ceiling=1.0, image_recon_lambda=0.1,
                 full_kl_step=6, kl_floor=0.5)


def assert_close(got, want, tol=TOL, what="", atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale + atol, (
        f"{what}: max err {err:.3g}, scale {scale:.3g}")


def make_weights(seed: int) -> dict:
    """The port's seed-made weights, perturbed so every leaf matters."""
    model = IQ(Config(**TINY), VOCAB).init_weights(
        torch.Generator().manual_seed(seed))
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
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


def port_model(weights, pallas: bool) -> IQ:
    model = IQ(Config(**TINY, use_pallas_attention=pallas), VOCAB)
    model.load_state_dict(weights)
    return model


_EPS = {}


def jax_eps(variables, cfg, key):
    """The posterior noise the JAX ``latent`` module draws under ``key``
    (compiled once per configuration, then called for each key)."""
    fn = _EPS.get(repr(cfg))
    if fn is None:
        draw = lambda m: jax.random.normal(m.latent.make_rng("latent"),
                                           (BATCH, cfg.latent_dim),
                                           jnp.float32)
        model = JaxIQ(cfg, VOCAB)
        fn = _EPS[repr(cfg)] = jax.jit(lambda v, k: model.apply(
            v, method=draw, rngs={"latent": k}))
    return np.array(fn(variables, key))


@pytest.fixture(scope="module")
def setup():
    weights = make_weights(SEED)
    params, stats = to_flax(weights)
    batch = make_batch(Config(**TINY), VOCAB, BATCH,
                       np.random.RandomState(SEED), device="cpu")
    pads = batch["target"] == 0
    assert bool(pads.any()) and not bool(pads.all(dim=1).any())
    return {"weights": weights, "variables": {"params": params,
                                              "batch_stats": stats},
            "batch": batch,
            "np_batch": {k: v.numpy() for k, v in batch.items()}}


def _jax_forward_and_grads(cfg, latent_mode):
    """Jitted (outputs, new batch stats, losses, grads) of the JAX train-mode
    forward, with the frozen backbone behind ``stop_gradient`` as in the
    JAX train step."""
    model = JaxIQ(cfg, VOCAB)

    def fn(params, batch_stats, batch, key):
        rngs = {"latent": key, "dropout": jax.random.fold_in(key, 1)}

        def loss_fn(params):
            params = jax.tree_util.tree_map_with_path(
                lambda p, x: (jax.lax.stop_gradient(x)
                              if _is_frozen_path(p) else x), params)
            outs, upd = model.apply(
                {"params": params, "batch_stats": batch_stats},
                batch["images"], batch["context"], batch["posterior"],
                batch["target"], latent_mode=latent_mode, train=True,
                rngs=rngs, mutable=["batch_stats"])
            logits, z_logit, kld, recon = outs
            out = jax_compute_losses(
                logits, batch["target"], recon, kld, z_logit,
                kliter=jnp.asarray(KLITER), latent_mode=latent_mode,
                **LOSS_ARGS)
            return out.loss, (outs, upd["batch_stats"], out)

        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return aux, grads

    return jax.jit(fn)


@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("latent_mode", [False, True],
                         ids=["pretrain", "latent"])
def test_train_forward_losses_and_grads(setup, latent_mode, pallas):
    cfg = JaxConfig(**TINY, use_pallas_attention=pallas)
    key = jax.random.key(7)
    (outs, new_stats, jlosses), jgrads = _jax_forward_and_grads(
        cfg, latent_mode)(setup["variables"]["params"],
                          setup["variables"]["batch_stats"],
                          setup["np_batch"], key)
    eps = torch.from_numpy(jax_eps(setup["variables"], cfg, key))

    model = port_model(setup["weights"], pallas)
    state = create_train_state(Config(**TINY, use_pallas_attention=pallas),
                               model, seed=None)
    b = setup["batch"]
    got = model(b["images"], b["context"], b["posterior"], b["target"],
                latent_mode=latent_mode, train=True,
                generator=torch.Generator().manual_seed(0), eps=eps)
    logits, z_logit, kld, (feat, recon) = got
    w_logits, w_z, w_kld, (w_feat, w_recon) = outs
    assert_close(logits.detach(), w_logits, what="logits")
    assert logits.dtype == torch.float32 and feat.dtype == torch.float32
    assert_close(kld.detach(), w_kld, what="kld")
    if latent_mode:
        assert z_logit.dtype == torch.float32
        assert_close(z_logit.detach(), w_z, what="z_logit")
    else:
        assert z_logit is None and w_z is None and float(kld) == 0.0
    assert_close(feat.detach(), w_feat, FEATURE_TOL, "image features")
    assert_close(recon.detach(), w_recon, what="recon")

    # batch statistics updated in place, flax's way
    want_stats = from_flax({}, jax.tree_util.tree_map(np.asarray, new_stats))
    buffers = dict(model.named_buffers())
    for name, want in want_stats.items():
        assert_close(buffers[name], want, what=name)

    losses = compute_losses(logits, b["target"], (feat, recon), kld, z_logit,
                            kliter=KLITER, latent_mode=latent_mode,
                            **LOSS_ARGS)
    for name, value in losses.as_dict().items():
        tol = FEATURE_TOL if name == "img" else TOL
        assert_close(value.detach(), getattr(jlosses, name), tol, name)

    params = state.trainable()
    grads = torch.autograd.grad(losses.loss, list(params.values()),
                                allow_unused=True)
    want_grads = from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert not any(p.requires_grad for n, p in model.named_parameters()
                   if n.startswith("encoder_cnn.backbone."))
    for name, g in zip(params, grads):
        want = want_grads[name]
        if g is None:   # unused in this phase: JAX's gradient is zero
            assert not want.any(), name
            continue
        tol = FEATURE_TOL if name.startswith(FEATURE_LEAVES) else TOL
        assert_close(g, want, tol, name, GRAD_ATOL)


@pytest.mark.parametrize("latent_mode,pallas",
                         [(False, False), (True, False), (True, True)],
                         ids=["pretrain", "latent", "latent-flash"])
def test_eval_step(setup, latent_mode, pallas):
    cfg = JaxConfig(**TINY, use_pallas_attention=pallas)
    variables = setup["variables"]
    params = variables["params"]
    jstate = JaxTrainState(
        step=jnp.asarray(5), kliter=jnp.asarray(KLITER), params=params,
        batch_stats=variables["batch_stats"], opt_state=None,
        tx=make_optimizer(cfg, params), apply_fn=JaxIQ(cfg, VOCAB).apply,
        lr_fn=jax_noam(cfg.hidden_dim, cfg.warmup_steps))
    rng = jax.random.key(11)
    want = jax_make_eval_step(cfg, latent_mode)(jstate, setup["np_batch"],
                                                rng)
    eps = torch.from_numpy(jax_eps(variables, cfg, jax.random.fold_in(rng,
                                                                       0)))

    pcfg = Config(**TINY, use_pallas_attention=pallas)
    state = create_train_state(pcfg, port_model(setup["weights"], pallas),
                               seed=None)
    state.kliter = KLITER
    before = {n: b.clone() for n, b in state.model.named_buffers()}
    got = make_eval_step(pcfg, latent_mode)(state, setup["batch"], eps=eps)
    assert set(got) == set(want)
    for name, value in got.items():
        assert_close(value, want[name], what=name)
    if latent_mode:
        assert 0.0 <= float(got["aux_acc"]) <= 1.0
    for n, b in state.model.named_buffers():
        assert torch.equal(b, before[n]), "eval must not move the statistics"


def test_eval_step_needs_a_noise_source():
    """Without a generator or eps the posterior noise would come from the
    global RNG, and the metrics would not follow from the arguments."""
    for latent_mode in (False, True):
        with pytest.raises(ValueError, match="generator or eps"):
            make_eval_step(Config(**TINY), latent_mode)(None, {})


def test_dropout():
    """Rate, 1/(1-p) scaling, dtype, and reproducibility from a generator;
    no generator (or rate 0) is the identity."""
    x = torch.full((400, 500), 2.0, dtype=torch.bfloat16)
    y = dropout(x, 0.25, torch.Generator().manual_seed(1))
    assert y.dtype == torch.bfloat16
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    assert bool((y[kept] == 2.0 / 0.75).all())
    again = dropout(x, 0.25, torch.Generator().manual_seed(1))
    other = dropout(x, 0.25, torch.Generator().manual_seed(2))
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, None) is x
    assert not dropout(x, 1.0, torch.Generator()).any()


def test_train_mode_dropout_draws_from_the_generator(setup):
    """With the default dropout rates, a train-mode forward depends on the
    generator's seed and is reproduced by it; eval mode ignores it (the
    posterior noise is injected, so only dropout could differ)."""
    weights = setup["weights"]
    cfg = Config(**{**TINY, "attention_dropout": 0.1, "relu_dropout": 0.1,
                    "target_word_dropout": 0.3})
    model = IQ(cfg, VOCAB)
    model.load_state_dict(weights)
    b = setup["batch"]

    def run(seed, train):
        with torch.no_grad():
            return model(b["images"], b["context"], b["posterior"],
                         b["target"], latent_mode=True, train=train,
                         generator=torch.Generator().manual_seed(seed),
                         eps=torch.zeros(BATCH, cfg.latent_dim))[0]

    first, again, other = run(1, True), run(1, True), run(2, True)
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert torch.equal(run(1, False), run(2, False))
