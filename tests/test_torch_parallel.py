"""Data, tensor and expert parallelism of the port across processes,
against the single-process port and against the JAX package.

- The sharding rules: the port's spec of every parameter of the tiny and
  the flagship trees equals the JAX ``param_sharding_rules`` spec (plain
  and ``fsdp=True``), and of every optimizer leaf the JAX
  ``opt_state_sharding_rules`` spec (the factored second moment too), on
  ``jax.eval_shape`` trees (nothing compiled); ``_zero1_spec`` and
  ``batch_sharding`` on the hybrid mesh.
- The steps: one spawn of 4 gloo ranks for the whole file
  (``torch_parallel_worker.py``, no jax in the children, one torch thread
  each) runs every scenario; each test case reads its scenario's per-rank
  errors against the single-process port step (pretrain step, Adam reset,
  latent step, then a latent eval step, dropout on): DP 4, DP 2 x TP 2,
  ZeRO-1 (fused, chain, factored second moment), FSDP, EP (data 2 x expert
  2, 4 experts), the hybrid mesh (dcn 2 x data 1 x model 2), a G = 2 multi
  step, and DP 4 on shards with unequal pad counts, where the mean of the
  ranks' own token means (the control) is not the global mean.  Limits:
  rtol 2e-4 / atol 1e-5 on metrics, parameters and moments, atol 1e-6 on
  the batch-norm statistics; every element is checked.  Adam's eps is
  1e-3 on both sides and ``feat_bn``'s scale 0.01 (see the worker): an
  element whose gradient is rounding noise moves by +-lr at eps 1e-8,
  and the train-mode batch norm over 8 images is ill-conditioned in f32.
- The data 2 x model 2 latent step against the JAX single-device step on
  the tests/test_multiprocess.py configuration (dropouts 0, the JAX
  posterior noise handed to the port): the metrics and the batch-norm
  statistics within rtol 2e-4 / atol 1e-5 (statistics atol 1e-6), as JAX
  tests/test_parallel.py holds its sharded step; every parameter and
  moment within the port-vs-JAX limits of tests/test_torch_train_step.py.
- What stays refused, with its reason (GPipe without a ``pipe`` axis,
  ``pipe`` beside a weight axis, a ring beside ``expert``, a mesh across
  processes without a world); and ``core/utils.py`` held equal to the JAX
  file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.parallel import mesh as jmesh
from blt_vqg_tpu.parallel import sharding as jsh
from blt_vqg_tpu.train.state import TrainState as JaxTrainState
from blt_vqg_tpu.train.state import make_optimizer
from blt_vqg_tpu.train.schedule import noam_schedule as jax_noam
from blt_vqg_tpu.train.step import make_train_step as jax_make_train_step
from blt_vqg_tpu_torch import serve
from blt_vqg_tpu_torch.convert import to_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.parallel import sharding as tsh
from blt_vqg_tpu_torch.train.fused_adam import FactoredNu
from blt_vqg_tpu_torch.train.state import create_train_state, make_optimizer \
    as port_optimizer
from blt_vqg_tpu_torch.train.step import make_batch
from test_torch_train_step import _check_state

STEP_SCENARIOS = ["dp4", "dp2_tp2", "zero1_fused", "zero1_chain",
                  "zero1_factored", "fsdp", "ep", "hybrid", "multi_step"]
WORLD, JOIN_S = 4, 240
TINY_JAX = dict(worker.TINY, attention_dropout=0.0, relu_dropout=0.0,
                layer_dropout=0.0, input_dropout=0.0, target_word_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the rules

def _leaf_specs(tree):
    """{flax path: spec tuple} of a pytree of NamedShardings."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jsh._path_str(path)] = tuple(s.spec)
    return out


def _trees(cfg_kw, vocab):
    """(JAX params as ShapeDtypeStructs, the port model on the meta
    device) of one configuration."""
    jcfg = JaxConfig(**cfg_kw)
    s = jcfg.image_size
    dummy = {"images": jnp.zeros((2, s, s, 3)),
             "context": jnp.zeros((2, jcfg.max_context_len), jnp.int32),
             "posterior": jnp.zeros((2, jcfg.max_posterior_len), jnp.int32),
             "target": jnp.zeros((2, jcfg.max_q_length), jnp.int32)}
    model = JaxIQ(jcfg, vocab)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "latent": jax.random.key(2)}, **dummy, latent_mode=True,
        train=False))
    with torch.device("meta"):
        port = IQ(Config(**cfg_kw), vocab)
    return jcfg, shapes["params"], port


FLAGSHIP_KW = dict(emb_dim=300, hidden_dim=1024, latent_dim=1024,
                   pwffn_dim=2048, num_layers=6, num_heads=8,
                   input_mode="cat", dtype="bfloat16", image_size=224)
TREES = {"tiny": (worker.TINY, worker.VOCAB),
         "flagship": (FLAGSHIP_KW, serve.FLAGSHIP_VOCAB)}


@pytest.fixture(scope="module")
def trees():
    return {k: _trees(*v) for k, v in TREES.items()}


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.build_mesh((2, 2, 2), ("data", "model", "expert"))


def _port_by_flax_path(specs, port):
    return {tsh.flax_leaf(n, tuple(p.shape))[0]: specs[n]
            for n, p in port.named_parameters()}


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("size", list(TREES))
def test_param_specs_match_jax(trees, jax_mesh, size, fsdp):
    _, jparams, port = trees[size]
    want = _leaf_specs(jsh.param_sharding_rules(jparams, jax_mesh,
                                                fsdp=fsdp))
    got = _port_by_flax_path(tsh.param_sharding_rules(port, jax_mesh,
                                                      fsdp=fsdp), port)
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == spec, path
    # the rules reach every kind of split on this mesh
    kinds = set(want.values())
    assert (({("data", "model"), ("model", "data")} if fsdp
             else {(None, "model"), ("model", None)}) <= kinds), kinds


@pytest.mark.parametrize("factored", [False, True], ids=["full_nu",
                                                         "factored_nu"])
@pytest.mark.parametrize("size", list(TREES))
def test_opt_state_specs_match_jax(trees, jax_mesh, size, factored):
    jcfg, jparams, port = trees[size]
    jcfg = jcfg.replace(adam_factored_nu=factored)
    jtx = make_optimizer(jcfg, jparams)
    jopt = jax.eval_shape(jtx.init, jparams)
    want = _leaf_specs(jsh.opt_state_sharding_rules(jopt, jax_mesh))
    ptx = port_optimizer(Config(**{**TREES[size][0],
                                   "adam_factored_nu": factored}))
    popt = ptx.init(dict(port.named_parameters()))
    got = tsh.opt_state_sharding_rules(popt, jax_mesh)
    assert want[".count"] == got["count"]
    n = 0
    for field in ("mu", "nu", "master"):
        for name, spec in got[field].items():
            p = dict(port.named_parameters())[name]
            path, _, _ = tsh.flax_leaf(name, tuple(p.shape))
            key = f".{field}/{path}"
            if isinstance(spec, FactoredNu):
                r, c = spec
                if path.endswith("kernel") and p.dim() == 2:
                    r, c = c, r            # the JAX pair, swapped back
                assert (want[key + "/.r"], want[key + "/.c"]) == (r, c), key
            else:
                assert want[key] == spec, key
            n += 1
    # every JAX leaf with an array has its port counterpart
    assert n == len([k for k in want if k != ".count"
                     and not k.endswith("/.c")])


def test_zero1_and_batch_specs_on_the_hybrid_mesh():
    jm = jmesh.build_hybrid_mesh(dcn_data=2, ici_data=2, model=2)
    assert tuple(jsh.batch_sharding(jm, 3).spec) == tsh.batch_sharding(jm, 3)
    assert tsh.batch_sharding(jm, 2) == (("dcn_data", "data"), None)
    for base, shape in [((), (8, 6)), ((None, "model"), (6, 8)),
                        (("model", None), (4, 3)), ((), (3, 5)),
                        (("expert", None, "model"), (4, 8, 6)), ((), ())]:
        assert (tuple(jsh._zero1_spec(jax.sharding.PartitionSpec(*base),
                                      shape, 2))
                == tsh._zero1_spec(base, shape, 2)), (base, shape)


# ---------------------------------------------------------------------------
# the steps, over 4 gloo ranks

def _jax_inputs(out_dir):
    """The port's seed-made weights (feat_bn scaled as in the worker), a
    batch and the JAX posterior noise of the step's key, for both sides."""
    cfg = Config(**TINY_JAX)
    state = worker.new_state(cfg)
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = make_batch(cfg, worker.VOCAB, 8, np.random.RandomState(9),
                       device="cpu")
    jcfg = JaxConfig(**TINY_JAX)
    params, stats = to_flax(sd)
    variables = {"params": params, "batch_stats": stats}
    rng = jax.random.key(300)
    draw = lambda m: jax.random.normal(m.latent.make_rng("latent"),
                                       (8, jcfg.latent_dim), jnp.float32)
    eps = np.array(JaxIQ(jcfg, worker.VOCAB).apply(
        variables, method=draw, rngs={"latent": jax.random.fold_in(rng, 0)}))
    flat = {"sd/" + k: v.numpy() for k, v in sd.items()}
    flat.update({"batch/" + k: v.numpy() for k, v in batch.items()})
    flat["eps"] = eps
    np.savez(os.path.join(out_dir, "jax_in.npz"), **flat)
    return jcfg, variables, batch, rng


def _jax_step(jcfg, variables, batch, rng):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = make_optimizer(jcfg, params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), kliter=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx,
        apply_fn=JaxIQ(jcfg, worker.VOCAB).apply,
        lr_fn=jax_noam(jcfg.hidden_dim, jcfg.warmup_steps))
    np_batch = {k: v.numpy() for k, v in batch.items()}
    jstate, jmetrics = jax_make_train_step(jcfg, True)(jstate, np_batch, rng)
    return (jax.tree_util.tree_map(np.array, jstate),
            jax.tree_util.tree_map(np.array, jmetrics))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario in one spawn of 4 ranks; the JAX step runs here
    meanwhile."""
    out = str(tmp_path_factory.mktemp("ranks"))
    jax_in = _jax_inputs(out)
    procs = worker.start(out, STEP_SCENARIOS + ["pads", "jax"], WORLD)
    jax_out = _jax_step(*jax_in)
    runs = worker.join(procs, JOIN_S)
    return {"dir": out, "runs": runs, "jax": jax_out}


def _result(ranks, name, rank):
    import json
    path = os.path.join(ranks["dir"], f"{name}.r{rank}.json")
    if not os.path.exists(path):
        rc, text = ranks["runs"][rank]
        pytest.fail(f"rank {rank} wrote no {name} result (exit {rc}):\n"
                    f"{text[-3000:]}")
    with open(path) as f:
        out = json.load(f)
    assert "error" not in out, out.get("error")
    return out


def _assert_within(out, what):
    worst = {**{f"metric {k}": v for k, v in out["metrics"].items()},
             **{f"eval {k}": v for k, v in out["eval"].items()},
             "parameters": out["params"], "batch-norm statistics": out["bn"],
             "optimizer state": out["opt"]}
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    assert not bad, f"{what}: over the limits (in units of atol): {bad}"
    assert out["step"] == out["ref_step"], what


@pytest.mark.parametrize("name", STEP_SCENARIOS)
def test_sharded_steps_match_one_process(ranks, name):
    for r in range(WORLD):
        _assert_within(_result(ranks, name, r), f"{name} rank {r}")


def test_global_token_normalisation_on_unequal_pads(ranks):
    for r in range(WORLD):
        out = _result(ranks, "pads", r)
        _assert_within(out, f"pads rank {r}")
        # the control: a mean of the shards' own means is another loss
        assert out["mean_of_means_err"] > 100.0, out["mean_of_means_err"]


def test_data2_model2_step_matches_jax(ranks):
    _result(ranks, "jax", 0)
    jstate, jmetrics = ranks["jax"]
    z = np.load(os.path.join(ranks["dir"], "jax_out.npz"))
    cfg = Config(**TINY_JAX)
    state = create_train_state(cfg, IQ(cfg, worker.VOCAB), seed=None)
    state.model.load_state_dict({k[3:]: torch.from_numpy(z[k])
                                 for k in z.files if k.startswith("sd/")})
    state.step, state.kliter, count = (int(c) for c in z["counts"])
    mu = {k[3:]: torch.from_numpy(z[k]) for k in z.files
          if k.startswith("mu/")}
    nu = {k[3:]: torch.from_numpy(z[k]) for k in z.files
          if k.startswith("nu/")}
    state.opt_state = state.opt_state._replace(count=count, mu=mu, nu=nu)
    metrics = {k[8:]: torch.from_numpy(z[k]) for k in z.files
               if k.startswith("metrics/")}
    # JAX tests/test_parallel.py's limits for its sharded step
    for key in ("loss", "rec", "img", "kld"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=2e-4, atol=1e-5, err_msg=key)
    got = state.model.state_dict()
    for (*mods, leaf), v in _flat(jstate.batch_stats):
        name = ".".join(mods + [{"mean": "running_mean",
                                 "var": "running_var"}[leaf]])
        np.testing.assert_allclose(got[name].numpy(), v, rtol=2e-4,
                                   atol=1e-6, err_msg=name)
    # and the whole state within the single-process port-vs-JAX limits
    _check_state(state, jstate, jmetrics, metrics, "data 2 x model 2")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ---------------------------------------------------------------------------
# what stays refused, and the copied module

def test_unported_parallelism_still_raises(tmp_path):
    """Every path of the JAX package is ported (tests/test_torch_p2p.py);
    what stays refused says why: GPipe without a 'pipe' axis, 'pipe'
    beside a weight axis, a ring beside 'expert', a mesh across processes
    without a world."""
    from blt_vqg_tpu_torch.core.checkpoint import CheckpointManager
    from blt_vqg_tpu_torch.parallel.mesh import build_mesh
    cfg = Config(**worker.TINY, pipeline_stages=2)
    model = IQ(cfg, worker.VOCAB)
    batch = make_batch(cfg, worker.VOCAB, 2, np.random.RandomState(0),
                       device="cpu")
    with pytest.raises(ValueError, match="'pipe' axis"):
        model(batch["images"], batch["context"], batch["posterior"],
              batch["target"], latent_mode=False, train=False)
    with pytest.raises(ValueError, match="batch axes"):
        build_mesh((2, 2), ("model", "pipe"), device="cpu")
    with pytest.raises(ValueError, match="expert"):
        build_mesh((1, 2, 2), ("data", "seq", "expert"), device="cpu")
    with pytest.raises(RuntimeError, match="not initialised"):
        build_mesh((2, 1, 2), ("data", "model", "seq"), device="cpu")
    assert CheckpointManager(str(tmp_path), backend="orbax").backend == \
        "orbax"


def test_dict2obj_is_the_jax_module():
    import blt_vqg_tpu.core.utils as jutils
    import blt_vqg_tpu_torch.core.utils as tutils
    with open(jutils.__file__) as a, open(tutils.__file__) as b:
        assert a.read() == b.read()
    obj = tutils.Dict2Obj({"a": 1, "b": [2]})
    assert (obj.a, obj.b) == (1, [2]) and repr(obj) == repr(
        jutils.Dict2Obj({"a": 1, "b": [2]}))
