"""The port's training entry point against the JAX package.

- ``config_from_args``: the same argv parses to the same ``Config`` in both
  packages (defaults, and overrides of int, float, str, bool and mesh
  flags).
- ``apply_glove_table`` matches the JAX function, and ``create_train_state``
  applies the table before the optimizer snapshots its f32 masters.
- ``make_multi_step`` with G=2 equals two single steps bit for bit.
- ``make_latent_diag_step`` matches the JAX step on the same weights
  (f32, 1e-5 of each value's scale; ``active_dims`` equal).
- ``load_resnet18_checkpoint`` loads a seed-made torchvision-layout
  ``state_dict`` (.pth and .npz) into the backbone as the JAX importer
  maps it, and ``cfg.resnet_ckpt`` grafts it at ``init_state``.
- ``RngStream``, ``EarlyStopping`` and ``ReduceLROnPlateau``.
- End to end on the CPU: ``Trainer.fit`` crosses the phase boundary,
  checkpoints, and a second trainer resumes with a state equal to the
  saved one bit for bit (as tests/test_e2e.py does for the JAX trainer);
  ``cli.train_iq.main`` trains against a synthetic hdf5 and against its
  packed form (multi-step dispatch, validation with the latent report),
  and a resumed CLI run starts from the checkpoint bit for bit.
- What the trainer refuses says what it needs: GPipe without a 'pipe'
  axis, and a mesh of one process that claims data ranks.
"""

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.core.config import add_config_args as jax_add_config_args
from blt_vqg_tpu.core.config import config_from_args as jax_config_from_args
from blt_vqg_tpu.core.rng import _stable_hash as jax_stable_hash
from blt_vqg_tpu.data.synthetic import write_synthetic_hdf5
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.models.iq import apply_glove_table as jax_apply_glove_table
from blt_vqg_tpu.ops.resnet import import_torch_resnet18 as jax_import_resnet
from blt_vqg_tpu.train.schedule import ReduceLROnPlateau as JaxPlateau
from blt_vqg_tpu.train.trainer import EarlyStopping as JaxEarlyStopping
from blt_vqg_tpu_torch.cli import train_iq
from blt_vqg_tpu_torch.convert import from_flax, to_flax
from blt_vqg_tpu_torch.core.checkpoint import flatten_state
from blt_vqg_tpu_torch.core.config import (Config, add_config_args,
                                           config_from_args)
from blt_vqg_tpu_torch.core.rng import RngStream, _stable_hash
from blt_vqg_tpu_torch.data.dataset import IQDataset
from blt_vqg_tpu_torch.data.loader import make_loader
from blt_vqg_tpu_torch.data.packed import pack_hdf5
from blt_vqg_tpu_torch.models.iq import IQ, apply_glove_table
from blt_vqg_tpu_torch.ops.resnet import (ResNet18Backbone,
                                          load_resnet18_checkpoint)
from blt_vqg_tpu_torch.parallel.mesh import Mesh
from blt_vqg_tpu_torch.text.vocabulary import Vocabulary
from blt_vqg_tpu_torch.train.schedule import ReduceLROnPlateau
from blt_vqg_tpu_torch.train.state import create_train_state
from blt_vqg_tpu_torch.train.step import (make_batch, make_latent_diag_step,
                                          make_multi_step, make_train_step)
from blt_vqg_tpu_torch.train.trainer import EarlyStopping, Trainer

VOCAB = 50
TOL = 1e-5
TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
            num_layers=2, num_heads=4, max_q_length=10, max_a_length=4,
            max_decode_length=8, dtype="float32", image_size=32)
# the end-to-end runs (tests/test_e2e.py's configuration)
E2E = dict(emb_dim=8, hidden_dim=16, latent_dim=12, pwffn_dim=32,
           num_layers=1, num_heads=2, batch_size=8, image_size=24,
           max_q_length=10, max_decode_length=6, num_pretraining_steps=2,
           total_training_steps=6, full_kl_step=3, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores.  The
    metric writer's optional TensorBoard sink is left out: importing it
    pulls in TensorFlow, seconds per process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    [],
    ["--hidden_dim", "64", "--lr", "0.001", "--input_mode", "cat",
     "--use_pallas_attention", "--no-compat_pad_seed", "--vocab", "v.json",
     "--no_checkpoint_at_end", "--steps_per_dispatch", "3",
     "--adam_factored_nu", "--decode_top_p", "0.9"],
    ["--sequence_parallel", "--num_seq_shards", "4", "--ring_attention_impl",
     "pallas", "--param_dtype", "bfloat16", "--emb_file", "g.txt"],
], ids=["defaults", "overrides", "seq_mesh"])
def test_config_from_args_matches_jax(argv):
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_add_config_args(jp)
    add_config_args(tp)
    want = jax_config_from_args(jp.parse_args(argv))
    got = config_from_args(tp.parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got, Config) and isinstance(want, JaxConfig)


def test_apply_glove_table_matches_jax():
    table = np.random.RandomState(0).randn(VOCAB, 16).astype(np.float32)
    model = IQ(Config(**TINY), VOCAB)
    params, _ = to_flax(model.state_dict())
    want = jax_apply_glove_table(
        jax.tree_util.tree_map(jnp.asarray, params), table)
    got = apply_glove_table(model, table)
    np.testing.assert_array_equal(got.embed.weight.detach().numpy(),
                                  np.asarray(want["embed"]["embedding"]))
    # bf16 storage: the master snapshots the f32 table, the parameter is
    # its bf16 rounding
    state = create_train_state(Config(**TINY, param_dtype="bfloat16"),
                               IQ(Config(**TINY), VOCAB), seed=0,
                               glove_table=table)
    assert torch.equal(state.opt_state.master["embed.weight"],
                       torch.from_numpy(table))
    assert torch.equal(state.model.embed.weight,
                       torch.from_numpy(table).to(torch.bfloat16))


@pytest.mark.parametrize("latent_mode", [False, True],
                         ids=["pretrain", "latent"])
def test_multi_step_equals_single_steps(latent_mode):
    cfg = Config(**TINY, input_mode="cat")
    states = [create_train_state(cfg, IQ(cfg, VOCAB), seed=0)
              for _ in range(2)]
    r = np.random.RandomState(1)
    batches = [make_batch(cfg, VOCAB, 3, r, "cpu") for _ in range(2)]
    gens = [lambda i: torch.Generator().manual_seed(100 + i)
            for _ in range(2)]
    single = make_train_step(cfg, latent_mode)
    for i, b in enumerate(batches):
        _, want = single(states[0], b, gens[0](i))
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    _, got = make_multi_step(cfg, latent_mode)(states[1], stacked, gens[1])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = flatten_state(states[0]), flatten_state(states[1])
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_latent_diag_matches_jax():
    cfg = Config(**TINY, input_mode="cat")
    model = IQ(cfg, VOCAB).init_weights(torch.Generator().manual_seed(3))
    batch = make_batch(cfg, VOCAB, 4, np.random.RandomState(2), "cpu")
    got = make_latent_diag_step(cfg, model)(
        batch["images"], batch["context"], batch["posterior"])
    params, stats = to_flax(model.state_dict())
    jmodel = JaxIQ(JaxConfig(**TINY, input_mode="cat"), VOCAB)
    want = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=type(jmodel).latent_diagnostics))(
        {"params": params, "batch_stats": stats},
        *(batch[k].numpy() for k in ("images", "context", "posterior")))
    assert set(got) == set(want)
    assert int(got["active_dims"]) == int(want["active_dims"])
    assert 0 < int(got["active_dims"]) < cfg.latent_dim
    for k in ("kl_per_dim", "prior_logvar", "post_logvar", "prior_mean_var",
              "mean_gap"):
        w = np.asarray(want[k], np.float64)
        err = np.abs(got[k].numpy() - w).max()
        assert err <= TOL * max(np.abs(w).max(), 1e-6), k


def _torchvision_resnet18_sd(seed: int) -> dict:
    """A seed-made ``state_dict`` in torchvision's resnet18 layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.randn((cout, cin, k, k), generator=g)

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.bias"] = torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, c in enumerate((64, 128, 256, 512), start=1):
        for b in range(2):
            p = f"layer{li}.{b}"
            conv(f"{p}.conv1", c, cin if b == 0 else c, 3)
            bn(f"{p}.bn1", c)
            conv(f"{p}.conv2", c, c, 3)
            bn(f"{p}.bn2", c)
            if b == 0 and cin != c:
                conv(f"{p}.downsample.0", c, cin, 1)
                bn(f"{p}.downsample.1", c)
        cin = c
    sd["fc.weight"] = torch.randn((1000, 512), generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


@pytest.mark.parametrize("ext", ["pth", "npz"])
def test_resnet18_checkpoint_loads(tmp_path, ext):
    sd = _torchvision_resnet18_sd(0)
    path = str(tmp_path / f"resnet18.{ext}")
    if ext == "pth":
        torch.save(sd, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    backbone = ResNet18Backbone(torch.float32)
    backbone.load_state_dict(load_resnet18_checkpoint(path))   # strict
    want = from_flax(*jax_import_resnet(sd))
    got = backbone.state_dict()
    assert set(got) == set(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k


def test_rng_stream_and_early_stopping():
    for name in ("dropout", "latent", "sample", ""):
        assert _stable_hash(name) == jax_stable_hash(name)
    a, b = RngStream(3), RngStream(3)
    draw = lambda g: torch.rand(4, generator=g)
    assert torch.equal(draw(a.key(5)), draw(b.key(5)))
    assert not torch.equal(draw(a.key(5)), draw(a.key(6)))
    assert not torch.equal(draw(a.key(5)), draw(RngStream(4).key(5)))
    keys = a.step_keys(5, "x", "y")
    assert not torch.equal(draw(keys["x"]), draw(keys["y"]))
    vals = [3.0, 2.0, 2.5, 2.4, 2.6, 1.0, 1.5, 1.6]
    for args in ((2, 0.0, 2), (3, 0.05, 0), (0, 0.0, 0)):
        j, t = JaxEarlyStopping(*args), EarlyStopping(*args)
        for step, v in enumerate(vals, start=1):
            assert t.update(step, v) == j.update(step, v)
            assert (t.best, t.stale) == (j.best, j.stale)


@pytest.mark.parametrize("kw", [dict(patience=1), dict(
    factor=0.5, patience=0, min_lr=1e-3, base_lr=0.1, min_delta=0.05)])
def test_reduce_lr_on_plateau_matches_jax(kw):
    j, t = JaxPlateau(**kw), ReduceLROnPlateau(**kw)
    for v in (3.0, 2.0, 2.5, 2.4, 2.6, 1.0, 1.5, 1.6, 1.7, 1.8, 0.9, 0.95):
        assert t.update(v) == j.update(v)


def _vocab(n=40):
    v = Vocabulary()
    for i in range(n - len(v)):
        v.add_word(f"w{i}")
    return v


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    h5 = write_synthetic_hdf5(str(root / "train.hdf5"), num_questions=32,
                              num_images=4, im_size=24, vocab_size=40,
                              uint8_images=True)
    vocab = _vocab()
    vocab.save(str(root / "vocab.json"))
    return {"root": root, "hdf5": h5, "vocab": vocab,
            "packed": pack_hdf5(h5, str(root / "packed"))}


def test_fit_across_phase_boundary_and_resume(synthetic, tmp_path):
    cfg = Config(**E2E, val_check_interval=100, checkpoint_every=3,
                 output_dir=str(tmp_path / "run"))
    vocab = synthetic["vocab"]
    ds = IQDataset(synthetic["hdf5"], vocab)
    trainer = Trainer(cfg, vocab, device="cpu")
    train_iter = make_loader(ds, cfg.batch_size, "ans", seed=0, device="cpu")
    first = next(train_iter)
    state = trainer.init_state(first, resume=False)
    state = trainer.fit(state, train_iter, lambda: make_loader(
        ds, cfg.batch_size, "ans", epochs=1, shuffle=False, device="cpu"))
    train_iter.close()
    assert state.step == cfg.total_training_steps
    assert state.kliter == (cfg.total_training_steps
                            - cfg.num_pretraining_steps)
    assert trainer.ckpt.all_steps() == [3, 6]
    # the Adam restart: the latent phase's 4 updates counted from zero
    assert state.opt_state.count == 4
    kld = {step: float(m["kld"]) for step, m in trainer.history}
    assert kld[2] == 0.0 and all(kld[s] > 0.0 for s in (3, 4, 5, 6))

    state2 = Trainer(cfg, vocab, device="cpu").init_state(first, resume=True)
    a, b = flatten_state(state), flatten_state(state2)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def _cli_argv(synthetic, data, out, steps, *extra):
    args = [f"--{k}={v}" for k, v in E2E.items()
            if k != "total_training_steps"]
    return args + [
        f"--total_training_steps={steps}", "--val_check_interval=3",
        "--limit_val_batches=1", "--checkpoint_every=2",
        "--steps_per_dispatch=2", "--latent_diagnostics", "--device=cpu",
        f"--vocab={synthetic['root'] / 'vocab.json'}",
        f"--dataset={synthetic[data]}", f"--val_dataset={synthetic[data]}",
        f"--output_dir={out}", *extra]


@pytest.mark.parametrize("data", ["hdf5", "packed"])
def test_cli_trains(synthetic, tmp_path, data, capsys, monkeypatch):
    out = tmp_path / "run"
    if data == "hdf5":
        r = train_iq.main(_cli_argv(synthetic, data, out, 6))
    else:
        # 4 steps, then a resumed run to 6: it starts from the step-4
        # checkpoint bit for bit
        r4 = train_iq.main(_cli_argv(synthetic, data, out, 4))
        saved = flatten_state(r4["state"])
        started = {}
        init_state = Trainer.init_state

        def spy(self, *a, **k):
            st = init_state(self, *a, **k)
            started.update(flatten_state(st))
            return st

        monkeypatch.setattr(Trainer, "init_state", spy)
        r = train_iq.main(_cli_argv(synthetic, data, out, 6, "--resume"))
        assert set(started) == set(saved)
        for k in saved:
            assert np.array_equal(started[k], saved[k]), k
    state, val, trainer = r["state"], r["val"], r["trainer"]
    assert (state.step, state.kliter) == (6, 4)
    assert trainer.ckpt.latest_step() == 6
    # dispatches of 2, 1, 1, 2 steps: [0, 1] pretrain, then latent
    steps = [s for s, _ in trainer.history]
    assert steps == ([2, 3, 4, 6] if data == "hdf5" else [6])
    for _, m in trainer.history:
        assert all(np.isfinite(float(v)) for v in m.values())
    for k in ("loss", "nlg_Bleu_4", "nlg_METEOR", "nlg_ROUGE_L", "nlg_CIDEr",
              "z_active_dims", "bleu4_prior_sample", "bleu4_prior_gap"):
        assert k in val and np.isfinite(val[k]), k
    printed = capsys.readouterr().out
    assert "##### validation @ step 6 #####" in printed
    assert "Generated:" in printed and "METEOR" in printed
    assert os.path.exists(out / "run_metrics.jsonl")


def test_init_state_grafts_resnet18(synthetic, tmp_path):
    """``cfg.resnet_ckpt`` loads the frozen backbone and its statistics
    (the optimizer holds nothing of it)."""
    sd = _torchvision_resnet18_sd(1)
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    cfg = Config(**E2E, resnet_ckpt=path, output_dir=str(tmp_path / "run"))
    state = Trainer(cfg, synthetic["vocab"], device="cpu").init_state(
        {}, resume=False)
    got = state.model.encoder_cnn.backbone.state_dict()
    assert torch.equal(got["stem_conv.weight"], sd["conv1.weight"])
    assert torch.equal(got["stage3_block1.bn2.running_var"],
                       sd["layer4.1.bn2.running_var"])
    assert not any(n.startswith("encoder_cnn.backbone.")
                   for n in state.opt_state.mu)


def test_unported_paths_raise(synthetic, tmp_path):
    cfg = Config(**E2E, output_dir=str(tmp_path))
    vocab = synthetic["vocab"]
    # GPipe is ported, over a mesh with a 'pipe' axis of the stage count
    with pytest.raises(ValueError, match="'pipe' axis"):
        Trainer(cfg.replace(pipeline_stages=2), vocab, device="cpu")
    # data parallelism is ported, across processes only: a mesh of one
    # process that claims 2 data ranks is refused
    with pytest.raises(ValueError, match="span processes"):
        Trainer(cfg, vocab, mesh=Mesh({"data": 2, "model": 1}, "cpu"),
                device="cpu")
