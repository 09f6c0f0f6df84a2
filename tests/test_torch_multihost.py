"""The port's multihost data path and sharded checkpoints against the JAX
package, and the train CLI over two processes.

- One spawn of 4 gloo ranks (data 2 x model 2; ``torch_parallel_worker.py``
  ``multihost``, no jax in the children): each rank's loader rows equal
  JAX ``_host_batches`` with the rank's ``data`` coordinate as its process
  index (the ranks of one data coordinate load the same rows); a ZeRO-1
  state after one step is written with ``save_sharded`` and restored bit
  for bit; the JAX ``restore_sharded`` reads the ranks' four
  ``shard_h*.npz`` and gets the whole state rank 0 wrote with the plain
  ``save``, bit for bit; and the ranks restore the JAX package's own
  sharded files (one host, a 2 x 2 mesh of virtual devices: several
  blocks per leaf in one file) to the JAX values, bit for bit.
- ``cli.train_iq`` under ``torch.distributed.run --nproc_per_node 2``
  with ``--device cpu --num_data_shards 2`` against the one-process CLI on
  the same data: rank 0 alone writes the checkpoints and the metric file,
  and its step-6 checkpoint equals the one-process run's within rtol 2e-4
  / atol 1e-5 (the batch-norm statistics atol 1e-6), except the fc bias in
  front of the train-mode batch norm, whose gradient is rounding noise
  (0 in exact arithmetic): it is held to the largest moves Adam can give
  that noise in the two runs.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from blt_vqg_tpu.core.checkpoint import CheckpointManager as JaxCkpt
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.data.dataset import IQDataset as JaxIQDataset
from blt_vqg_tpu.data.loader import _host_batches as jax_host_batches
from blt_vqg_tpu.data.synthetic import write_synthetic_hdf5
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.parallel.mesh import build_mesh as jax_build_mesh
from blt_vqg_tpu.parallel.sharding import shard_opt_state, shard_params
from blt_vqg_tpu.train.state import create_train_state as jax_train_state
from blt_vqg_tpu_torch.cli import train_iq
from blt_vqg_tpu_torch.data.packed import pack_hdf5
from blt_vqg_tpu_torch.text.vocabulary import Vocabulary
from blt_vqg_tpu_torch.train.schedule import noam_schedule

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD, JOIN_S = 4, 180


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread; the metric writer's TensorBoard sink left out
    (its import pulls in TensorFlow, seconds per process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(n)


def _vocab():
    v = Vocabulary()
    for w in ("<pad>", "<start>", "<unk>", "<end>"):
        v.add_word(w)
    for i in range(worker.VOCAB - 4):
        v.add_word(f"w{i}")
    return v


def _jax_state(root):
    """A JAX train state of the worker's configuration at step 1 with
    numpy-made moments (no step is compiled), on a data 2 x model 2 mesh
    with ZeRO-1 moments, written by the JAX package's sharded and plain
    saves."""
    cfg = JaxConfig(**worker.TINY)
    r = np.random.RandomState(4)
    batch = {"images": r.rand(8, 24, 24, 3).astype(np.float32),
             "context": r.randint(1, worker.VOCAB,
                                  (8, cfg.max_context_len)).astype(np.int32),
             "posterior": r.randint(1, worker.VOCAB, (
                 8, cfg.max_posterior_len)).astype(np.int32),
             "target": r.randint(1, worker.VOCAB,
                                 (8, cfg.max_q_length)).astype(np.int32)}
    state = jax_train_state(cfg, JaxIQ(cfg, worker.VOCAB),
                            jax.random.key(0), batch)
    noise = np.random.RandomState(5)
    state = state.replace(
        step=jnp.ones((), jnp.int32),
        opt_state=jax.tree_util.tree_map(
            lambda x: (jnp.asarray(noise.rand(*x.shape).astype(x.dtype))
                       if x.ndim else x + 1), state.opt_state))
    mesh = jax_build_mesh((2, 2))
    state = state.replace(params=shard_params(state.params, mesh),
                          opt_state=shard_opt_state(state.opt_state, mesh))
    JaxCkpt(os.path.join(root, "jax_sharded")).save_sharded(state)
    JaxCkpt(os.path.join(root, "jax_plain")).save(state)
    return state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multihost"))
    h5 = write_synthetic_hdf5(os.path.join(root, "d.hdf5"), num_questions=40,
                              num_images=5, im_size=24,
                              vocab_size=worker.VOCAB, uint8_images=True)
    vocab = _vocab()
    vocab.save(os.path.join(root, "vocab.json"))
    pack_hdf5(h5, os.path.join(root, "packed"))
    procs = worker.start(root, ["multihost"], WORLD)
    jstate = _jax_state(root)        # meanwhile; the ranks wait for it
    open(os.path.join(root, "jax_sharded.ready"), "w").close()
    runs = worker.join(procs, JOIN_S)
    return {"root": root, "h5": h5, "vocab": vocab, "runs": runs,
            "jax": jstate}


def _result(ranks, rank):
    path = os.path.join(ranks["root"], f"multihost.r{rank}.json")
    if not os.path.exists(path):
        rc, text = ranks["runs"][rank]
        pytest.fail(f"rank {rank} wrote no result (exit {rc}):\n"
                    f"{text[-3000:]}")
    with open(path) as f:
        out = json.load(f)
    assert "error" not in out, out.get("error")
    return out


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_loader_rows_follow_the_data_coordinate(ranks):
    jds = JaxIQDataset(ranks["h5"], ranks["vocab"])
    for rank in range(WORLD):
        _result(ranks, rank)
        got = np.load(os.path.join(ranks["root"], f"rows_r{rank}.npz"))
        data = rank // 2           # mesh (data 2, model 2): model innermost
        want = list(jax_host_batches(jds, 8, "ans", True, 3, True, 1,
                                     process_index=data, process_count=2))
        assert got["image_ids"].shape == (len(want), 4)
        np.testing.assert_array_equal(
            got["image_ids"], np.stack([b["image_ids"] for b in want]))
        np.testing.assert_array_equal(
            got["target"], np.stack([b["target"] for b in want]))


def test_sharded_round_trip_is_bit_equal(ranks):
    for rank in range(WORLD):
        out = _result(ranks, rank)
        assert out["round_trip_bit_equal"], rank
        assert out["shard_params_equal"], rank
        # 4 rows a rank of the global 8, by the data coordinate
        assert out["local_batch"] == [4 * (rank // 2), 8], rank
    files = sorted(os.listdir(os.path.join(ranks["root"], "port_sharded",
                                           "step_1")))
    assert files == ["args.json"] + [f"shard_h{r}.npz" for r in range(WORLD)]


def _same(a: dict, b: dict, what: str):
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), (what, k)


def test_jax_restores_the_ports_shard_files(ranks):
    _result(ranks, 0)
    root = ranks["root"]
    got = JaxCkpt(os.path.join(root, "port_sharded")).restore_sharded(
        ranks["jax"])
    # the JAX package's own plain layout of what it restored
    JaxCkpt(os.path.join(root, "jax_view")).save(got)
    want = _npz(os.path.join(root, "port_plain", "step_1", "state.npz"))
    have = _npz(os.path.join(root, "jax_view", "step_1", "state.npz"))
    _same(have, want, "port shard files read by the JAX package")


def test_trainer_fits_and_reports_under_fsdp(ranks):
    """``Trainer.fit`` on data 2 x model 2 with FSDP: every rank ends at
    step 2 with the same validation loss; rank 0 alone scores the report,
    decoded with the gathered weights in a model of its own."""
    fits = [_result(ranks, r)["fit"] for r in range(WORLD)]
    assert all(f["step"] == 2 for f in fits)
    assert len({f["val"]["loss"] for f in fits}) == 1, fits
    assert np.isfinite(fits[0]["val"]["loss"])
    assert fits[0]["split_report_model"]
    for k in ("nlg_Bleu_4", "nlg_CIDEr", "bleu4_prior_gap"):
        assert np.isfinite(fits[0]["val"][k]), k
        assert all(k not in f["val"] for f in fits[1:]), k
    assert sorted(os.listdir(os.path.join(ranks["root"], "fit",
                                          "checkpoints"))) == ["step_2"]


def test_port_restores_the_jax_shard_files(ranks):
    for rank in range(WORLD):
        assert _result(ranks, rank)["step"] == 1
    root = ranks["root"]
    with np.load(os.path.join(root, "jax_sharded", "step_1",
                              "shard_h0.npz")) as z:
        blocks = [k for k in z.files if k.startswith(
            "params/decoder/layer_0/ffn/ffn_in/kernel@")]
    assert len(blocks) >= 2          # one JAX file, several blocks a leaf
    want = _npz(os.path.join(root, "jax_plain", "step_1", "state.npz"))
    have = _npz(os.path.join(root, "port_from_jax", "step_1", "state.npz"))
    _same(have, want, "JAX shard files read by the port")


# ---------------------------------------------------------------------------
# the train CLI over two processes

E2E = dict(emb_dim=8, hidden_dim=16, latent_dim=12, pwffn_dim=32,
           num_layers=1, num_heads=2, batch_size=8, image_size=24,
           max_q_length=10, max_decode_length=6, num_pretraining_steps=2,
           total_training_steps=6, full_kl_step=3, dtype="float32")


def _cli_argv(ranks, out, *extra):
    return [f"--{k}={v}" for k, v in E2E.items()] + [
        "--val_check_interval=3", "--limit_val_batches=1",
        "--checkpoint_every=3", "--device=cpu",
        f"--vocab={os.path.join(ranks['root'], 'vocab.json')}",
        f"--dataset={os.path.join(ranks['root'], 'packed')}",
        f"--val_dataset={os.path.join(ranks['root'], 'packed')}",
        f"--output_dir={out}", *extra]


def test_train_cli_over_two_processes(ranks, tmp_path):
    # the children skip the metric writer's TensorBoard sink (seconds of
    # imports a process)
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path / "site"), ROOT]))
    env.pop("JAX_PLATFORMS", None)
    two_ranks = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "blt_vqg_tpu_torch.cli.train_iq",
         *_cli_argv(ranks, tmp_path / "two"), "--num_data_shards=2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT)
    try:
        one = train_iq.main(_cli_argv(ranks, tmp_path / "one"))
        out, _ = two_ranks.communicate(timeout=240)
    finally:
        two_ranks.kill()
    assert one["state"].step == 6
    assert two_ranks.returncode == 0, out[-4000:]
    two = tmp_path / "two"
    assert sorted(os.listdir(two / "checkpoints")) == ["step_3", "step_6"]
    assert (two / "args.json").exists()
    with open(two / "run_metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    # rank 0 alone writes: one validation record per validation
    assert sum(1 for d in lines if "val_loss" in json.dumps(d)) == 3
    a = _npz(tmp_path / "one" / "checkpoints" / "step_6" / "state.npz")
    b = _npz(two / "checkpoints" / "step_6" / "state.npz")
    assert set(a) == set(b)
    # the fc bias in front of the train-mode batch norm has a gradient of
    # 0 in exact arithmetic: Adam moves it by rounding noise, up to about
    # lr a step in either run, whatever the summation order
    lr = noam_schedule(E2E["hidden_dim"], JaxConfig().warmup_steps)
    noise = 2 * 3 * sum(lr(s) for s in range(6))
    for k in a:
        if a[k].dtype.kind != "f":
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        elif k == "params/encoder_cnn/fc/bias":
            assert np.abs(b[k] - a[k]).max() <= noise, k
        else:
            atol = 1e-6 if k.startswith("batch_stats/") else 1e-5
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=atol,
                                       err_msg=k)
