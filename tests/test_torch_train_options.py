"""Two train-step options of the port against the JAX package:
``grad_dtype="bfloat16"`` and ``fused_adam=False`` (the optax chain).

- A pretrain step with bf16 gradients: the metrics (the global norm taken
  over the bf16 leaves) and the parameters within 1e-5 of each tensor's
  scale (2e-3 where a value comes from the train-mode image features, see
  tests/test_torch_train.py); each Adam moment within that tolerance of
  its tensor's scale plus one bf16 rounding of the gradient (2^-7 of mu's
  value, 2^-6 of nu's, relative), since a gradient the two packages
  compute a few f32 ulps apart may round to neighbouring bf16 values (and
  the absolute floors of tests/test_torch_train_step.py for gradients
  that are zero in exact arithmetic).
- A pretrain step with ``fused_adam=False`` against the JAX chain: metrics,
  parameters and the chain's ``scale_by_adam`` count and moments, within
  the same 1e-5.
- ``fused_adam=False`` checkpoints: the JAX package's restores into the
  port and the port's into a JAX chain state, bit for bit; a fused state
  refuses a chain checkpoint with a message naming both layouts; the JAX
  package's refusals of bf16 parameters and factored second moments under
  the chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blt_vqg_tpu.core.checkpoint import CheckpointManager as JaxManager
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.train.schedule import noam_schedule as jax_noam
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import make_optimizer as jax_make_optimizer
from blt_vqg_tpu.train.step import make_train_step as jax_make_train_step
from blt_vqg_tpu_torch.convert import (from_flax, load_train_state,
                                       train_state_to_flax)
from blt_vqg_tpu_torch.core.checkpoint import CheckpointManager
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.train.state import create_train_state, make_optimizer
from blt_vqg_tpu_torch.train.step import make_train_step
from test_torch_train import (FEATURE_LEAVES, FEATURE_TOL, GRAD_ATOL, TINY,
                              TOL, VOCAB, assert_close, port_model,
                              setup)  # noqa: F401  (setup is a fixture)
from test_torch_train_step import _moments

BF16_REL = 2.0 ** -7      # one bf16 rounding, relative


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(cfg, variables):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(cfg, params)
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), kliter=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx, apply_fn=JaxIQ(cfg, VOCAB).apply,
        lr_fn=jax_noam(cfg.hidden_dim, cfg.warmup_steps))


def _step_both(setup, over):
    """One pretrain step of each package from the same weights and batch:
    (JAX state, JAX metrics, port state, port metrics)."""
    cfg = JaxConfig(**TINY, **over)
    jstate = _jax_state(cfg, setup["variables"])
    jstate, jmetrics = jax_make_train_step(cfg, False)(
        jstate, setup["np_batch"], jax.random.key(3))
    pcfg = Config(**TINY, **over)
    state = create_train_state(pcfg, port_model(setup["weights"], False),
                               seed=None)
    state, metrics = make_train_step(pcfg, False)(
        state, setup["batch"], torch.Generator().manual_seed(0))
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    assert set(metrics) == set(jmetrics)
    for name, value in metrics.items():
        tol = FEATURE_TOL if name == "img" else TOL
        assert_close(value, jmetrics[name], tol, name)
    want = from_flax(jstate.params, jstate.batch_stats)
    got = state.model.state_dict()
    for name, w in want.items():
        tol = FEATURE_TOL if name.startswith("encoder_cnn.") else TOL
        assert_close(got[name], w, tol, name)
    return jstate, state


def test_bf16_grad_step_matches_jax(setup):
    jstate, state = _step_both(setup, {"grad_dtype": "bfloat16"})
    assert state.opt_state.count == int(jstate.opt_state.count) == 1
    # nu holds g^2, whose relative rounding is twice g's
    for field, rel, atol in (("mu", BF16_REL, 0.1 * GRAD_ATOL),
                             ("nu", 2 * BF16_REL, 1e-3 * GRAD_ATOL)):
        want = _moments(getattr(jstate.opt_state, field))
        got = getattr(state.opt_state, field)
        assert set(got) == set(want), field
        for name, w in want.items():
            g = got[name].detach().double().numpy()
            w = np.asarray(w, np.float64)
            tol = FEATURE_TOL if name.startswith(FEATURE_LEAVES) else TOL
            err = np.abs(g - w)
            bound = rel * np.abs(w) + tol * np.abs(w).max() + atol
            assert (err <= bound).all(), (
                f"{field} {name}: max err {err.max():.3g}")


def test_unfused_chain_step_matches_jax(setup):
    jstate, state = _step_both(setup, {"fused_adam": False})
    adam = jstate.opt_state.inner_states["train"].inner_state[1]
    assert state.tx.chain and state.opt_state.count == int(adam.count) == 1
    assert state.opt_state.master == {}
    for field, atol in (("mu", 0.1 * GRAD_ATOL), ("nu", 1e-3 * GRAD_ATOL)):
        want = _moments(getattr(adam, field))
        got = getattr(state.opt_state, field)
        assert set(got) == set(want), field
        for name, w in want.items():
            tol = FEATURE_TOL if name.startswith("encoder_cnn.") else TOL
            assert_close(got[name], w, tol, f"{field} {name}", atol)


# ---------------------------------------------------------------------------
CHAIN = {"fused_adam": False}


def _fill(tree, r, positive=False):
    def one(a):
        v = r.rand(*a.shape) + 0.5 if positive else r.randn(*a.shape)
        return jnp.asarray(np.asarray(v, np.float32).astype(a.dtype))
    return jax.tree_util.tree_map(one, tree)


@pytest.fixture(scope="module")
def chain_jax(setup):
    """A JAX chain ``TrainState`` with seed-made moments, count 3, step 7,
    kliter 2 (nothing compiled)."""
    cfg = JaxConfig(**TINY, **CHAIN)
    r = np.random.RandomState(5)
    params = _fill(setup["variables"]["params"], r)
    tx = jax_make_optimizer(cfg, params)
    opt = tx.init(params)
    train = opt.inner_states["train"]
    _, adam, last = train.inner_state
    adam = adam._replace(count=jnp.asarray(3, jnp.int32),
                         mu=_fill(adam.mu, r),
                         nu=_fill(adam.nu, r, positive=True))
    opt.inner_states["train"] = train._replace(
        inner_state=(train.inner_state[0], adam, last))
    return JaxTrainState(
        step=jnp.asarray(7, jnp.int32), kliter=jnp.asarray(2, jnp.int32),
        params=params,
        batch_stats=_fill(setup["variables"]["batch_stats"], r, True),
        opt_state=opt, tx=tx, apply_fn=None, lr_fn=None)


def _port_chain():
    return create_train_state(Config(**TINY, **CHAIN),
                              IQ(Config(**TINY), VOCAB), seed=0)


def test_port_restores_jax_chain_checkpoint(tmp_path, chain_jax):
    JaxManager(str(tmp_path)).save(chain_jax, JaxConfig(**TINY, **CHAIN))
    got = CheckpointManager(str(tmp_path)).restore(_port_chain())
    want = load_train_state(_port_chain(), chain_jax)
    assert (got.step, got.kliter, got.opt_state.count) == (7, 2, 3)
    assert (want.step, want.kliter, want.opt_state.count) == (7, 2, 3)
    for k, t in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], t), k
    for field in ("mu", "nu"):
        a, b = getattr(got.opt_state, field), getattr(want.opt_state, field)
        assert list(a) == list(b) and a, field
        for k in a:
            assert torch.equal(a[k], b[k]), (field, k)
    # a fused train state refuses it, naming both layouts
    fused = create_train_state(Config(**TINY), IQ(Config(**TINY), VOCAB),
                               seed=0)
    with pytest.raises(ValueError) as err:
        CheckpointManager(str(tmp_path)).restore(fused)
    assert ("fused_adam=False" in str(err.value)
            and "fused_adam=True" in str(err.value)), str(err.value)


def test_jax_restores_port_chain_checkpoint(tmp_path, chain_jax):
    state = _port_chain()
    g = torch.Generator().manual_seed(6)
    opt = state.opt_state
    state.opt_state = opt._replace(
        count=4, mu={n: torch.randn(v.shape, generator=g)
                     for n, v in opt.mu.items()},
        nu={n: torch.rand(v.shape, generator=g) + 0.5
            for n, v in opt.nu.items()})
    state.step, state.kliter = 9, 5
    CheckpointManager(str(tmp_path)).save(state, Config(**TINY, **CHAIN))
    got = JaxManager(str(tmp_path)).restore(chain_jax)
    want = train_state_to_flax(state, masked=optax.MaskedNode())
    adam = got.opt_state.inner_states["train"].inner_state[1]
    assert (int(got.step), int(got.kliter), int(adam.count)) == (9, 5, 4)
    is_leaf = lambda x: isinstance(x, optax.MaskedNode)
    for g_tree, w_tree in ((got.params, want["params"]),
                           (adam.mu, want["mu"]), (adam.nu, want["nu"])):
        g_leaves, g_def = jax.tree_util.tree_flatten(g_tree, is_leaf=is_leaf)
        w_leaves, w_def = jax.tree_util.tree_flatten(w_tree, is_leaf=is_leaf)
        assert g_def == w_def
        for a, b in zip(jax.tree_util.tree_leaves(g_leaves),
                        jax.tree_util.tree_leaves(w_leaves)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("over,words", [
    ({"param_dtype": "bfloat16"}, "f32 master copy"),
    ({"adam_factored_nu": True}, "factored second moment")])
def test_chain_refuses_what_jax_refuses(over, words):
    cfg = dict(**TINY, **CHAIN, **over)
    with pytest.raises(ValueError, match=words) as ours:
        make_optimizer(Config(**cfg))
    with pytest.raises(ValueError) as theirs:
        jax_make_optimizer(JaxConfig(**cfg), {})
    assert str(ours.value) == str(theirs.value)
