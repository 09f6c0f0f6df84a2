"""The train CLI with a ``seq`` ring across two processes.

``cli.train_iq --sequence_parallel --num_seq_shards 2`` under
``torch.distributed.run --nproc_per_node 2`` with ``--device cpu`` (gloo:
each process one rank of the ring, ``("data", "model", "seq")`` built from
the flags as the JAX CLI builds it) against the same CLI in one process,
where the ``seq`` axis stays the one-process ``LocalRing``: rank 0 alone
writes the checkpoints, and its step-4 checkpoint equals the one-process
run's within rtol 2e-4 / atol 1e-5 (the batch-norm statistics atol 1e-6),
except the fc bias in front of the train-mode batch norm, whose gradient
is rounding noise (0 in exact arithmetic), held to the largest moves Adam
can give that noise (as tests/test_torch_multihost.py holds it).  Attention
dropout is 0, so the decoder's self-attention takes the ring.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.data.synthetic import write_synthetic_hdf5
from blt_vqg_tpu_torch.cli import train_iq
from blt_vqg_tpu_torch.data.packed import pack_hdf5
from blt_vqg_tpu_torch.train.schedule import noam_schedule
from test_torch_multihost import _npz, _vocab

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
E2E = dict(emb_dim=8, hidden_dim=16, latent_dim=12, pwffn_dim=32,
           num_layers=1, num_heads=2, batch_size=8, image_size=24,
           max_q_length=10, max_decode_length=6, num_pretraining_steps=2,
           total_training_steps=4, full_kl_step=3, dtype="float32",
           attention_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(n)


def _argv(root, out, *extra):
    return [f"--{k}={v}" for k, v in E2E.items()] + [
        "--val_check_interval=4", "--limit_val_batches=1",
        "--checkpoint_every=4", "--device=cpu", "--sequence_parallel",
        "--num_seq_shards=2", f"--vocab={os.path.join(root, 'vocab.json')}",
        f"--dataset={os.path.join(root, 'packed')}",
        f"--val_dataset={os.path.join(root, 'packed')}",
        f"--output_dir={out}", *extra]


def test_train_cli_seq_ring_over_two_processes(tmp_path):
    root = str(tmp_path)
    h5 = write_synthetic_hdf5(os.path.join(root, "d.hdf5"), num_questions=40,
                              num_images=5, im_size=24,
                              vocab_size=worker.VOCAB, uint8_images=True)
    _vocab().save(os.path.join(root, "vocab.json"))
    pack_hdf5(h5, os.path.join(root, "packed"))
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path / "site"), ROOT]))
    env.pop("JAX_PLATFORMS", None)
    two_ranks = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "blt_vqg_tpu_torch.cli.train_iq",
         *_argv(root, tmp_path / "two")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT)
    try:
        one = train_iq.main(_argv(root, tmp_path / "one"))
        out, _ = two_ranks.communicate(timeout=240)
    finally:
        two_ranks.kill()
    assert one["state"].step == 4
    assert one["trainer"].model.mesh.shape["seq"] == 2
    assert two_ranks.returncode == 0, out[-4000:]
    two = tmp_path / "two"
    assert sorted(os.listdir(two / "checkpoints")) == ["step_4"]
    a = _npz(tmp_path / "one" / "checkpoints" / "step_4" / "state.npz")
    b = _npz(two / "checkpoints" / "step_4" / "state.npz")
    assert set(a) == set(b)
    lr = noam_schedule(E2E["hidden_dim"], JaxConfig().warmup_steps)
    noise = 2 * 3 * sum(lr(s) for s in range(4))
    for k in a:
        if a[k].dtype.kind != "f":
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        elif k == "params/encoder_cnn/fc/bias":
            assert np.abs(b[k] - a[k]).max() <= noise, k
        else:
            atol = 1e-6 if k.startswith("batch_stats/") else 1e-5
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=atol,
                                       err_msg=k)
