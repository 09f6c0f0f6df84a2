"""The port's ``CheckpointManager`` (npz and orbax) against the JAX
package's.

- A checkpoint the JAX ``CheckpointManager`` wrote restores into the port's
  train state, and one the port wrote restores into a JAX ``TrainState``
  template, bit for bit (every parameter, batch statistic, Adam moment and
  master, the count, step and kliter), with full and factored second
  moments and with bf16 parameters over f32 masters.  The JAX side is
  built from ``jax.eval_shape`` of the init (values made from a seed), so
  nothing is compiled.
- ``on_disk_param_dtype="bfloat16"``: the parameters on disk are bf16
  (void values with a dtype record), the moments are not, and both
  packages restore them, cast back to f32, exactly.
- The orbax backend (through tensorstore): a JAX Orbax checkpoint restores
  into the port's train state, and the port's into a JAX template, bit for
  bit, in the three layouts; the port's has Orbax's files and the sidecars.
- Retention of the ``keep`` newest steps, asynchronous writes (the host
  copy is taken at the call), the sidecar files, the layout check on
  ``adam_factored_nu`` (a clear message naming both layouts), an unknown
  backend, and the orbax backend's error where tensorstore is missing.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blt_vqg_tpu.core.checkpoint import CheckpointManager as JaxManager
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.train import fused_adam as jfa
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import make_optimizer
from blt_vqg_tpu_torch.convert import load_train_state, train_state_to_flax
from blt_vqg_tpu_torch.core.checkpoint import CheckpointManager
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.train.fused_adam import FactoredNu
from blt_vqg_tpu_torch.train.state import create_train_state

VOCAB = 50
TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
            num_layers=2, num_heads=4, max_q_length=10, max_a_length=4,
            max_decode_length=8, dtype="float32", image_size=32)
LAYOUTS = {"full_nu": {}, "factored_nu": {"adam_factored_nu": True},
           "bf16_params": {"param_dtype": "bfloat16"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init_shapes():
    """Paths, shapes and dtypes of the JAX init tree (latent phase)."""
    cfg = JaxConfig(**TINY)
    b = 2
    args = (np.zeros((b, 32, 32, 3), np.float32),
            np.ones((b, cfg.max_context_len), np.int32),
            np.ones((b, cfg.max_posterior_len), np.int32),
            np.ones((b, cfg.max_q_length), np.int32))
    rngs = {"params": jax.random.key(0), "latent": jax.random.key(1),
            "dropout": jax.random.key(2)}
    return jax.eval_shape(
        lambda r, *a: JaxIQ(cfg, VOCAB).init(r, *a, latent_mode=True,
                                             train=False), rngs, *args)


def _fill(tree, r, positive=False):
    def one(a):
        v = r.rand(*a.shape) + 0.5 if positive else r.randn(*a.shape)
        return jnp.asarray(np.asarray(v, np.float32).astype(a.dtype))
    return jax.tree_util.tree_map(one, tree)


def _jax_state(shapes, layout, seed):
    """A JAX ``TrainState`` of the layout with seed-made values everywhere
    (moments nonzero, count 3, step 7, kliter 2)."""
    cfg = JaxConfig(**TINY, **LAYOUTS[layout])
    r = np.random.RandomState(seed)
    params = _fill(shapes["params"], r)
    stats = _fill(shapes["batch_stats"], r, positive=True)
    tx = make_optimizer(cfg, params)
    opt = tx.init(params)
    opt = opt._replace(count=jnp.asarray(3, jnp.int32), mu=_fill(opt.mu, r),
                       nu=_fill(opt.nu, r, positive=True),
                       master=_fill(opt.master, r))
    params = tx.cast_params(params)
    return JaxTrainState(step=jnp.asarray(7, jnp.int32),
                         kliter=jnp.asarray(2, jnp.int32), params=params,
                         batch_stats=stats, opt_state=opt, tx=tx,
                         apply_fn=None, lr_fn=None)


def _port_state(layout):
    cfg = Config(**TINY, **LAYOUTS[layout])
    return create_train_state(cfg, IQ(Config(**TINY), VOCAB), seed=0)


def _fill_port(state, seed):
    """Seed-made moments and masters, count 3, step 7, kliter 2."""
    g = torch.Generator().manual_seed(seed)

    def rnd(t, positive=False):
        v = torch.rand(t.shape, generator=g) + 0.5 if positive else \
            torch.randn(t.shape, generator=g)
        return v.to(t.dtype)

    opt = state.opt_state
    mu = {n: rnd(v) for n, v in opt.mu.items()}
    nu = {n: (FactoredNu(rnd(v.r, True), rnd(v.c, True))
              if isinstance(v, FactoredNu) else rnd(v, True))
          for n, v in opt.nu.items()}
    master = {n: rnd(v) for n, v in opt.master.items()}
    state.opt_state = opt._replace(count=3, mu=mu, nu=nu, master=master)
    with torch.no_grad():
        for t in state.model.state_dict().values():
            t.copy_(rnd(t, positive=True))
    state.step, state.kliter = 7, 2
    return state


def _assert_states_equal(a, b):
    assert (a.step, a.kliter, a.opt_state.count) == (
        b.step, b.kliter, b.opt_state.count)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k
    for field in ("mu", "nu", "master"):
        ta, tb = getattr(a.opt_state, field), getattr(b.opt_state, field)
        assert list(ta) == list(tb), field
        for k in ta:
            va, vb = ta[k], tb[k]
            pairs = (zip(va, vb) if isinstance(va, FactoredNu)
                     else [(va, vb)])
            for x, y in pairs:
                assert x.dtype == y.dtype and torch.equal(x, y), (field, k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_restores_jax_checkpoint(tmp_path, init_shapes, layout):
    jstate = _jax_state(init_shapes, layout, seed=1)
    JaxManager(str(tmp_path)).save(jstate, JaxConfig(**TINY))
    got = CheckpointManager(str(tmp_path)).restore(_port_state(layout))
    want = load_train_state(_port_state(layout), jstate)
    _assert_states_equal(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_restores_port_checkpoint(tmp_path, init_shapes, layout):
    state = _fill_port(_port_state(layout), seed=2)
    CheckpointManager(str(tmp_path)).save(state, Config(**TINY))
    template = _jax_state(init_shapes, layout, seed=3)
    got = JaxManager(str(tmp_path)).restore(template)
    want = train_state_to_flax(state, masked=optax.MaskedNode(),
                               factored=jfa.FactoredNu)
    _assert_jax_equals(got, want)


def _assert_jax_equals(got, want):
    """A restored JAX ``TrainState`` equals ``train_state_to_flax``'s
    trees, leaf by leaf."""
    assert (int(got.step), int(got.kliter), int(got.opt_state.count)) == (
        want["step"], want["kliter"], want["count"])
    is_leaf = lambda x: isinstance(x, (optax.MaskedNode, jfa.FactoredNu))
    for g_tree, w_tree in ((got.params, want["params"]),
                           (got.batch_stats, want["batch_stats"]),
                           (got.opt_state.mu, want["mu"]),
                           (got.opt_state.nu, want["nu"]),
                           (got.opt_state.master, want["master"])):
        g_leaves, g_def = jax.tree_util.tree_flatten(g_tree, is_leaf=is_leaf)
        w_leaves, w_def = jax.tree_util.tree_flatten(w_tree, is_leaf=is_leaf)
        assert g_def == w_def
        for g, w in zip(jax.tree_util.tree_leaves(g_leaves),
                        jax.tree_util.tree_leaves(w_leaves)):
            np.testing.assert_array_equal(
                np.asarray(g).astype(np.float32), np.asarray(w))


def test_bf16_on_disk_restores_in_both(tmp_path, init_shapes):
    state = _fill_port(_port_state("full_nu"), seed=4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, on_disk_param_dtype="bfloat16")
    with np.load(tmp_path / "step_7" / "state.npz") as z:
        dtypes = {k: str(z[k]) for k in z.files if k.startswith("__dtype__/")}
        assert dtypes and set(dtypes.values()) == {"bfloat16"}
        assert all(k.startswith("__dtype__/params/") for k in dtypes)
        assert z["opt_state/.mu/embed/embedding"].dtype == np.float32
    back = mgr.restore(_port_state("full_nu"))
    sd, bsd = state.model.state_dict(), back.model.state_dict()
    for k, t in sd.items():
        want = (t if k.endswith(("running_mean", "running_var"))
                else t.to(torch.bfloat16).float())
        assert bsd[k].dtype == torch.float32 and torch.equal(bsd[k], want), k
    jgot = JaxManager(str(tmp_path)).restore(
        _jax_state(init_shapes, "full_nu", seed=5))
    np.testing.assert_array_equal(
        np.asarray(jgot.params["embed"]["embedding"]),
        sd["embed.weight"].to(torch.bfloat16).float().numpy())


def test_retention_async_and_sidecars(tmp_path):
    state = _port_state("full_nu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 5):
        state.step = step
        mgr.save(state, Config(**TINY), extra={"step": step}, block=False)
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    d = tmp_path / "step_4"
    assert Config.load(str(d / "args.json")) == Config(**TINY)
    assert json.loads((d / "extra.json").read_text()) == {"step": 4}


def test_async_save_copies_at_the_call(tmp_path):
    state = _fill_port(_port_state("full_nu"), seed=6)
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    mu_before = {k: v.clone() for k, v in state.opt_state.mu.items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, block=False)
    with torch.no_grad():                # the next train step, in place
        for t in state.model.parameters():
            t.add_(1.0)
        for v in state.opt_state.mu.values():
            v.add_(1.0)
    back = mgr.restore(_port_state("full_nu"))
    for k, t in back.model.state_dict().items():
        assert torch.equal(t, before[k]), k
    for k, v in back.opt_state.mu.items():
        assert torch.equal(v, mu_before[k]), k


@pytest.mark.parametrize("saved,restored", [("full_nu", "factored_nu"),
                                            ("factored_nu", "full_nu")])
def test_optimizer_layout_mismatch_fails_clearly(tmp_path, saved, restored):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_state(saved))
    with pytest.raises(ValueError) as err:
        mgr.restore(_port_state(restored))
    msg = str(err.value)
    assert ("adam_factored_nu=True" in msg
            and "adam_factored_nu=False" in msg), msg


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_restores_jax_orbax_checkpoint(tmp_path, init_shapes, layout):
    jstate = _jax_state(init_shapes, layout, seed=1)
    JaxManager(str(tmp_path), backend="orbax").save(jstate,
                                                    JaxConfig(**TINY))
    mgr = CheckpointManager(str(tmp_path), backend="orbax")
    assert mgr.all_steps() == [7]
    got = mgr.restore(_port_state(layout))
    want = load_train_state(_port_state(layout), jstate)
    _assert_states_equal(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_restores_port_orbax_checkpoint(tmp_path, init_shapes, layout):
    state = _fill_port(_port_state(layout), seed=2)
    mgr = CheckpointManager(str(tmp_path), backend="orbax", keep=1)
    mgr.save(state, Config(**TINY), extra={"step": 7}, block=False)
    mgr.wait()
    d = tmp_path / "step_7"
    assert {"args.json", "extra.json", "orbax"} <= set(os.listdir(d))
    assert {"_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt",
            "d"} <= set(os.listdir(d / "orbax"))
    template = _jax_state(init_shapes, layout, seed=3)
    got = JaxManager(str(tmp_path), backend="orbax").restore(template)
    want = train_state_to_flax(state, masked=optax.MaskedNode(),
                               factored=jfa.FactoredNu)
    _assert_jax_equals(got, want)
    # and the port reads its own back, bit for bit
    _assert_states_equal(mgr.restore(_port_state(layout)), state)


def test_unported_backends_raise(tmp_path):
    from blt_vqg_tpu_torch.core import checkpoint as ck
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        CheckpointManager(str(tmp_path), backend="msgpack")
    # the orbax backend names what it needs where tensorstore is missing
    real = ck._tensorstore
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(__import__("sys").modules, "tensorstore", None)
        with pytest.raises(ImportError, match="tensorstore"):
            real()
    mgr = CheckpointManager(str(tmp_path))
    # the sharded save is ported (tests/test_torch_multihost.py): with no
    # checkpoint there is nothing to restore
    with pytest.raises(FileNotFoundError):
        mgr.restore_sharded(_port_state("full_nu"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_port_state("full_nu"))
