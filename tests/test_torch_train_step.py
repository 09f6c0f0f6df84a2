"""The port's train step and ``FusedClipAdam`` against the JAX package.

- Two pretrain steps, the phase-boundary optimizer reset, then two latent
  steps, in both packages from the same weights and batch (the setup of
  tests/test_torch_train.py: every dropout 0, the JAX posterior noise
  injected into the port), with ``use_pallas_attention`` off and on.
  After every step: parameters, batch statistics, Adam moments, the step
  count, step and kliter, and the metrics.  Tolerance 1e-5 of each tensor's
  largest magnitude, 2e-3 where a value is computed from the train-mode
  image features or is a batch statistic of the image encoder (see
  tests/test_torch_train.py), 5e-5 for the moments of
  the latent prior net (its gradient is the KL term alone, scaled by the
  anneal weight, and at kliter 0 that weight, tanh(-3) + 1, differs between
  the libraries by 1.2e-5 of itself: one ulp of tanh), and absolute floors
  for moments of a gradient that is zero in exact arithmetic.
- ``FusedClipAdam`` alone on synthetic trees against the JAX class: both
  clip branches, bf16 first moments, the factored second moment and f32
  masters of bf16 parameters, to 1e-6 relative (f32 values; the masters'
  bf16 copies to one bf16 rounding).
- The Noam schedule and the KL anneal against the JAX functions, and the
  ``guard_nonfinite`` skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.train import fused_adam as jfa
from blt_vqg_tpu.train.losses import kl_weight_schedule as jax_kl_weight
from blt_vqg_tpu.train.schedule import noam_schedule as jax_noam
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import make_optimizer
from blt_vqg_tpu.train.step import make_train_step as jax_make_train_step
from blt_vqg_tpu_torch.convert import from_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.train import fused_adam as tfa
from blt_vqg_tpu_torch.train.losses import kl_weight_schedule
from blt_vqg_tpu_torch.train.schedule import noam_schedule
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import make_train_step
from test_torch_train import (FEATURE_LEAVES, FEATURE_TOL, GRAD_ATOL, TINY,
                              TOL, VOCAB, assert_close, jax_eps, port_model,
                              setup)  # noqa: F401  (setup is a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _moments(tree):
    """A JAX moment tree with its MaskedNode leaves dropped, by port name."""
    def keep(node):
        if isinstance(node, dict):
            kept = {k: keep(v) for k, v in node.items()}
            return {k: v for k, v in kept.items() if v is not None}
        return None if isinstance(node, tuple) else np.array(node)
    return from_flax(keep(tree))


KL_ONLY_LEAVES, KL_TOL = ("latent.prior.",), 5e-5


def _check_state(state, jstate, jmetrics, metrics, what):
    """The port's state and metrics against a JAX state (as numpy)."""
    assert state.step == int(jstate.step) and state.kliter == int(
        jstate.kliter), what
    assert state.opt_state.count == int(jstate.opt_state.count), what
    want = from_flax(_np(jstate.params), _np(jstate.batch_stats))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        # every statistic of the image encoder comes from its train-mode
        # batch norms, as do the features
        tol = FEATURE_TOL if name.startswith("encoder_cnn.") else TOL
        assert_close(got[name], w, tol, f"{what}: {name}")
    for field, atol in (("mu", 0.1 * GRAD_ATOL), ("nu", 1e-3 * GRAD_ATOL)):
        want = _moments(getattr(jstate.opt_state, field))
        got = getattr(state.opt_state, field)
        assert set(got) == set(want), field
        for name, w in want.items():
            tol = (FEATURE_TOL if name.startswith(FEATURE_LEAVES) else
                   KL_TOL if name.startswith(KL_ONLY_LEAVES) else TOL)
            assert_close(got[name], w, tol, f"{what}: {field} {name}", atol)
    assert set(metrics) == set(jmetrics)
    for name, value in metrics.items():
        tol = FEATURE_TOL if name == "img" else TOL
        assert_close(value, jmetrics[name], tol, f"{what}: {name}")


@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "flash"])
def test_steps_match_jax(setup, pallas):
    cfg = JaxConfig(**TINY, use_pallas_attention=pallas)
    variables = setup["variables"]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = make_optimizer(cfg, params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), kliter=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx, apply_fn=JaxIQ(cfg, VOCAB).apply,
        lr_fn=jax_noam(cfg.hidden_dim, cfg.warmup_steps))

    pcfg = Config(**TINY, use_pallas_attention=pallas)
    state = create_train_state(pcfg, port_model(setup["weights"], pallas),
                               seed=None)
    batch, np_batch = setup["batch"], setup["np_batch"]
    gen = torch.Generator().manual_seed(0)
    jax_steps = {lm: jax_make_train_step(cfg, lm) for lm in (False, True)}
    for i, latent_mode in enumerate((False, False, True, True)):
        if i == 2:
            jstate = jstate.reset_optimizer()
            state.reset_optimizer()
        rng = jax.random.key(100 + i)
        jstate, jmetrics = jax_steps[latent_mode](jstate, np_batch, rng)
        jstate, jmetrics = _np(jstate), _np(jmetrics)
        eps = torch.from_numpy(jax_eps(variables, cfg,
                                       jax.random.fold_in(rng, 0)))
        state, metrics = make_train_step(pcfg, latent_mode)(state, batch,
                                                            gen, eps=eps)
        _check_state(state, jstate, jmetrics, metrics, f"step {i}")
        jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    assert state.kliter == 2 and state.step == 4


# ---------------------------------------------------------------------------
def _synthetic(seed: int):
    """(JAX params, port params, [grads per step]) of a small tree with a
    frozen leaf; grads at scales that clip and that do not."""
    r = np.random.RandomState(seed)
    shapes = {"w": (16, 8), "b": (8,), "f": (4, 4)}
    params = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * r.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.01, 10.0, 0.3)]
    return params, grads


@pytest.mark.parametrize("mu_dtype,factored,mixed", [
    ("float32", False, False), ("bfloat16", False, False),
    ("float32", True, False), ("float32", False, True)],
    ids=["default", "bf16_mu", "factored_nu", "f32_masters"])
def test_fused_clip_adam_matches_jax(mu_dtype, factored, mixed):
    params, grads = _synthetic(seed=1)
    frozen = lambda path: path[0].key == "f"
    jtx = jfa.FusedClipAdam(
        5.0, frozen, mu_dtype=jnp.dtype(mu_dtype),
        master_fn=(lambda path: path[0].key == "w") if mixed else None,
        factored_nu=factored)
    ttx = tfa.FusedClipAdam(
        5.0, lambda n: n == "f",
        mu_dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[
            mu_dtype],
        master_fn=(lambda n: n == "w") if mixed else None,
        factored_nu=factored)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    jparams = jtx.cast_params(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tparams)
    ttx.cast_params(tparams)
    for step, g in enumerate(grads):
        lr = jax_noam(32, 2)(step + 1)
        jg = {k: jnp.asarray(v).astype(jparams[k].dtype) for k, v in g.items()}
        jparams, jstate, jnorm = jtx.update_params(jparams, jg, jstate, lr)
        tg = {k: torch.from_numpy(v).to(tparams[k].dtype) for k, v in g.items()}
        tstate, tnorm = ttx.update_params(tparams, tg, tstate, float(lr))
        assert_close(tnorm, jnorm, 1e-6, "grad norm")
        assert tstate.count == int(jstate.count)
        for k in ("w", "b"):
            tol = 8e-3 if tparams[k].dtype == torch.bfloat16 else 1e-6
            assert_close(tparams[k].float(), jparams[k].astype(jnp.float32),
                         tol, f"step {step}: param {k}")
            assert_close(tstate.mu[k].float(),
                         jstate.mu[k].astype(jnp.float32), 1e-6, f"mu {k}")
            assert tstate.mu[k].dtype == (torch.bfloat16
                                          if mu_dtype == "bfloat16"
                                          else torch.float32)
            jnu, tnu = jstate.nu[k], tstate.nu[k]
            if factored and k == "w":
                assert isinstance(tnu, tfa.FactoredNu)
                assert_close(tnu.r, jnu.r, 1e-6, "nu r")
                assert_close(tnu.c, jnu.c, 1e-6, "nu c")
            else:
                assert_close(tnu, jnu, 1e-6, f"nu {k}")
        assert "f" not in tstate.mu and "f" not in tstate.nu
        assert torch.equal(tparams["f"].float(), torch.from_numpy(
            np.array(jparams["f"].astype(jnp.float32))))
        if mixed:
            assert set(tstate.master) == {"w"}
            assert_close(tstate.master["w"], jstate.master["w"], 1e-6,
                         "master")


def test_global_norm_is_the_update_norm():
    """The norm a skipped step reports is the one ``update_params`` clips
    with: over the trainable names only, a missing gradient as zero."""
    params, grads = _synthetic(seed=2)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    g = {k: torch.from_numpy(v) for k, v in grads[1].items()}
    g["b"] = None
    ttx = tfa.FusedClipAdam(5.0, lambda n: n == "f")
    state = ttx.init(tparams)
    norm = tfa.global_norm(g, state.mu)
    assert torch.equal(norm, torch.sqrt(torch.sum(g["w"] ** 2)))
    _, update_norm = ttx.update_params(tparams, g, state, 1e-3)
    assert torch.equal(norm, update_norm)


def test_schedules_match_jax():
    lr, jlr = noam_schedule(32, 7), jax_noam(32, 7)
    for step in (0, 1, 6, 7, 8, 1000):
        assert lr(step) == float(jlr(step))
    # tanh differs by an ulp between the libraries; near tanh(-3) + 1 that
    # is 1.2e-5 of the weight
    for kliter in (0, 1, 3, 5, 20):
        assert abs(float(kl_weight_schedule(kliter, 6)) - float(
            jax_kl_weight(jnp.asarray(kliter), 6))) <= 1e-7


def test_guard_nonfinite_skips_the_update(setup):
    """A non-finite loss leaves parameters, moments and statistics as they
    were; step and kliter advance and the skip is reported."""
    cfg = Config(**TINY, guard_nonfinite=True)
    state = create_train_state(cfg, port_model(setup["weights"], False),
                               seed=None)
    batch = dict(setup["batch"])
    batch["images"] = torch.full_like(batch["images"], float("nan"))
    before = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, metrics = make_train_step(cfg, True)(state, batch,
                                                torch.Generator())
    assert float(metrics["skipped_nonfinite"]) == 1.0
    assert not bool(torch.isfinite(metrics["loss"]))
    assert (state.step, state.kliter, state.opt_state.count) == (1, 1, 0)
    for name, t in state.model.state_dict().items():
        assert torch.equal(t, before[name]), name
    state, metrics = make_train_step(cfg, True)(state, setup["batch"],
                                                torch.Generator())
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert (state.step, state.kliter, state.opt_state.count) == (2, 2, 1)
