"""Weights and configuration carried between the JAX package and the port.

- every leaf of the JAX ``IQ.init`` (both phases' trees, seed-made values
  in the init's shapes and dtypes) maps onto the port's ``state_dict`` with
  matching shapes and round-trips bit-exact;
- an npz checkpoint written by the JAX ``CheckpointManager`` loads through
  ``convert.load_npz`` (no jax) to identical tensors, with f32 and with
  bf16 (void-byte) parameters on disk;
- the port's ``Config`` has the JAX ``Config``'s fields and defaults, and
  reads the JAX trainer's ``args.json``;
- a JAX ``TrainState`` after one optimizer step (params, batch stats,
  step, kliter and the ``FusedAdamState`` with its masked frozen leaves,
  plain and with the factored second moment) carries into the port's
  train state and back bit-exact;
- the port, and ``chip_smoke.py``, import with jax, flax and the JAX
  package unavailable.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.checkpoint import CheckpointManager
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
import optax

from blt_vqg_tpu.train import fused_adam as jfa
from blt_vqg_tpu.train.schedule import noam_schedule as jax_noam
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import make_optimizer
from blt_vqg_tpu_torch.convert import (from_flax, load_npz, load_train_state,
                                       to_flax, train_state_to_flax)
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.train import fused_adam as tfa
from blt_vqg_tpu_torch.train.state import create_train_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 50
TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
            num_layers=2, num_heads=4, max_q_length=10, max_a_length=4,
            max_decode_length=8, dtype="float32", image_size=32)


def _init_args(cfg, b=2):
    r = np.random.RandomState(0)
    return (r.rand(b, cfg.image_size, cfg.image_size, 3).astype(np.float32),
            np.ones((b, cfg.max_context_len), np.int32),
            np.ones((b, cfg.max_posterior_len), np.int32),
            np.ones((b, cfg.max_q_length), np.int32))


def _rngs():
    return {"params": jax.random.key(0), "latent": jax.random.key(1),
            "dropout": jax.random.key(2)}


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX IQ.init tree of the latent phase (the pretrain phase's tree
    is a subset of it, checked by shape below): its leaves' paths, shapes
    and dtypes by ``jax.eval_shape``, filled with seed-made values (what
    carries between the packages does not depend on the values, and
    compiling the init took most of this file's time)."""
    cfg = JaxConfig(**TINY)
    model = JaxIQ(cfg, VOCAB)
    shapes = jax.eval_shape(
        lambda rngs, *a: model.init(rngs, *a, latent_mode=True, train=False),
        _rngs(), *_init_args(cfg))
    r = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: (0.5 + r.rand(*s.shape)).astype(s.dtype), shapes)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_every_leaf_maps_and_round_trips(jax_variables):
    params, stats = jax_variables["params"], jax_variables["batch_stats"]
    sd = from_flax(params, stats)
    model = IQ(Config(**TINY), VOCAB)
    port_sd = model.state_dict()
    assert set(sd) == set(port_sd)
    for key, t in sd.items():
        assert t.shape == port_sd[key].shape, key
    model.load_state_dict(sd)                       # strict
    params2, stats2 = to_flax(model.state_dict())
    for tree, back in ((params, params2), (stats, stats2)):
        flat, flat_back = _flat(tree), _flat(back)
        assert set(flat) == set(flat_back)
        for path, arr in flat.items():
            assert flat_back[path].dtype == arr.dtype, path
            np.testing.assert_array_equal(flat_back[path], arr,
                                          err_msg="/".join(path))


@pytest.mark.parametrize("latent_mode,tie", [(False, False), (True, True)])
def test_other_trees_map(jax_variables, latent_mode, tie):
    """The pretrain-phase tree, and the tree with tied output/z heads, by
    shape: every leaf has a home of the same shape in the port."""
    cfg = JaxConfig(**TINY, tie_output_z=tie)
    model = JaxIQ(cfg, VOCAB)
    shapes = jax.eval_shape(
        lambda rngs, *a: model.init(rngs, *a, latent_mode=latent_mode,
                                    train=False), _rngs(), *_init_args(cfg))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    sd = from_flax(zeros["params"], zeros["batch_stats"])
    port_sd = IQ(Config(**TINY, tie_output_z=tie), VOCAB).state_dict()
    if latent_mode:
        assert set(sd) == set(port_sd)
    else:
        full = from_flax(jax_variables["params"], jax_variables["batch_stats"])
        assert set(sd) < set(full)
    for key, t in sd.items():
        assert t.shape == port_sd[key].shape, key


@pytest.mark.parametrize("disk_dtype", [None, "bfloat16"])
def test_load_npz_matches(tmp_path, jax_variables, disk_dtype):
    params, stats = jax_variables["params"], jax_variables["batch_stats"]
    state = types.SimpleNamespace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state={}, step=7, kliter=0)
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    ckpt.save(state, JaxConfig(**TINY), on_disk_param_dtype=disk_dtype)
    got_p, got_s, step = load_npz(str(tmp_path / "checkpoints"))
    assert step == 7
    want = from_flax(params, stats)
    got = from_flax(got_p, got_s)
    assert set(got) == set(want)
    for key, t in want.items():
        is_param = not key.endswith(("running_mean", "running_var"))
        if disk_dtype and is_param:
            assert got[key].dtype == torch.bfloat16, key
            t = t.to(torch.bfloat16)
        assert got[key].dtype == t.dtype, key
        assert torch.equal(got[key], t), key


def test_config_fields_and_defaults_match(tmp_path):
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(Config)}
    assert list(tf) == list(jf)
    assert tf == jf
    jcfg = JaxConfig(**TINY, input_mode="cat", use_stream_decode=True,
                     stream_head_dtype="int8")
    jcfg.save(str(tmp_path / "args.json"))
    cfg = Config.load(str(tmp_path / "args.json"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.head_dim, cfg.max_target_len, cfg.max_context_len) == (
        jcfg.head_dim, jcfg.max_target_len, jcfg.max_context_len)


@pytest.mark.parametrize("factored", [False, True],
                         ids=["full_nu", "factored_nu"])
def test_train_state_round_trip(jax_variables, factored):
    cfg = JaxConfig(**TINY, adam_factored_nu=factored)
    params = jax.tree_util.tree_map(jnp.asarray, jax_variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, jax_variables["batch_stats"])
    tx = make_optimizer(cfg, params)
    jstate = JaxTrainState(
        step=jnp.asarray(3, jnp.int32), kliter=jnp.asarray(1, jnp.int32),
        params=params, batch_stats=stats, opt_state=tx.init(params), tx=tx,
        apply_fn=None, lr_fn=jax_noam(cfg.hidden_dim, 2))
    r = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(r.randn(*p.shape).astype(np.float32)), params)
    new_stats = jax.tree_util.tree_map(lambda s: s + 0.5, stats)
    # one compiled update (the eager one dispatches every leaf's ops)
    jstate = jax.jit(lambda st, g, bs: st.apply_gradients(
        g, new_batch_stats=bs, kliter_inc=1))(jstate, grads, new_stats)

    state = create_train_state(Config(**TINY, adam_factored_nu=factored),
                               IQ(Config(**TINY), VOCAB), seed=None)
    load_train_state(state, jstate)
    assert (state.step, state.kliter, state.opt_state.count) == (4, 2, 1)
    frozen = [n for n, _ in state.model.named_parameters()
              if n.startswith("encoder_cnn.backbone.")]
    assert frozen and not set(frozen) & set(state.opt_state.mu)
    if factored:
        assert isinstance(state.opt_state.nu["embed_proj.weight"],
                          tfa.FactoredNu)
    back = train_state_to_flax(state, masked=optax.MaskedNode(),
                               factored=jfa.FactoredNu)
    opt = jstate.opt_state
    assert (back["step"], back["kliter"], back["count"]) == (
        int(jstate.step), int(jstate.kliter), int(opt.count))
    for want, got in ((jstate.params, back["params"]),
                      (jstate.batch_stats, back["batch_stats"]),
                      (opt.mu, back["mu"]), (opt.nu, back["nu"]),
                      (opt.master, back["master"])):
        is_leaf = lambda x: isinstance(x, (optax.MaskedNode, jfa.FactoredNu))
        w_leaves, w_def = jax.tree_util.tree_flatten(want, is_leaf=is_leaf)
        g_leaves, g_def = jax.tree_util.tree_flatten(got, is_leaf=is_leaf)
        assert w_def == g_def
        for w, g in zip(w_leaves, g_leaves):
            assert type(w) is type(g) or isinstance(g, np.ndarray)
            for wa, ga in zip(jax.tree_util.tree_leaves(w),
                              jax.tree_util.tree_leaves(g)):
                np.testing.assert_array_equal(np.asarray(ga), np.asarray(wa))


def test_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'flax', 'blt_vqg_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import blt_vqg_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'blt_vqg_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
