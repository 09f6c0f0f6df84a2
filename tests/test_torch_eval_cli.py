"""The port's evaluation entry points against the JAX package's.

One tiny model directory is trained on the CPU by the port's train CLI
on a learnable synthetic corpus (f32, ``decode_z_source="prior_mean"``,
checkpoints at steps 20 and 40 (pretrain) and 60 (latent)); the JAX
package restores the port's npz checkpoints.  Then, on the same directory:

- ``evaluate_iq`` greedy with ``--num-z-samples 2`` (the latent step 60),
  ``--from-category``, and beam search (``--beam-size 2 --max-batches 1``)
  give the JAX CLI's ``preds.json``, ``gts.json`` and ``z_samples.json``
  exactly and its ``results.json`` within 1e-9.  Beam search runs on the
  pretrain checkpoint (``--step 40``): in the latent phase the JAX beam
  search draws z from the prior whatever ``decode_z_source`` says, and the
  two packages' random draws differ.
- The packed directory and the hdf5 file of the same data evaluate alike;
  ``test_iq`` writes what ``evaluate_iq`` writes; a sampled decode with
  ``--decode-top-k 1`` gives the greedy questions.
- A directory trained with ``grad_dtype="bfloat16"`` evaluates as the f32
  one does, and so does one with ``fused_adam=False``, whose checkpoints
  hold the optax chain's optimizer state (the fused checkpoints with their
  count and moments moved to the chain's keys: the two optimizers hold the
  same numbers).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from blt_vqg_tpu.cli import evaluate_iq as jax_evaluate
from blt_vqg_tpu_torch.cli import evaluate_iq, test_iq, train_iq
from blt_vqg_tpu_torch.data.packed import pack_hdf5
from blt_vqg_tpu_torch.data.synthetic import write_synthetic_hdf5
from blt_vqg_tpu_torch.text.vocabulary import Vocabulary

# the learnable corpus's recipe of tests/test_decode.py: after 50 pretrain
# steps the questions follow the category (BLEU-4 about 0.8), so the
# decodes compared below are not one repeated token
TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=16, pwffn_dim=64,
            num_layers=1, num_heads=2, batch_size=32, image_size=16,
            max_q_length=20, max_decode_length=8, warmup_steps=20,
            num_pretraining_steps=50, total_training_steps=60,
            full_kl_step=10, dtype="float32", input_mode="cat")
FILES = ("preds.json", "gts.json", "z_samples.json")
# the runs compared with the JAX CLI: name -> evaluate_iq flags
RUNS = {"greedy": ["--num-z-samples", "2"],
        "category": ["--from-category", "--num-z-samples", "2",
                     "--max-batches", "1"],
        "beam": ["--beam-size", "2", "--max-batches", "1", "--step", "40"]}


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


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    h5 = write_synthetic_hdf5(str(root / "data.hdf5"), num_questions=128,
                              num_images=8, im_size=16, vocab_size=40,
                              learnable=True)
    vocab = Vocabulary()
    for i in range(40 - len(vocab)):
        vocab.add_word(f"w{i}")
    vocab.save(str(root / "vocab.json"))
    out = root / "run"
    train_iq.main([f"--{k}={v}" for k, v in TINY.items()] + [
        "--decode_z_source=prior_mean", "--checkpoint_every=20",
        "--no-compat_pad_seed",
        "--val_check_interval=100", "--limit_val_batches=1", "--device=cpu",
        f"--vocab={root / 'vocab.json'}", f"--dataset={h5}",
        f"--val_dataset={h5}", f"--output_dir={out}"])
    return {"root": root, "dir": str(out), "hdf5": h5,
            "packed": pack_hdf5(h5, str(root / "packed"))}


def _read(path):
    out = {}
    for name in FILES + ("results.json",):
        if os.path.exists(os.path.join(path, name)):
            with open(os.path.join(path, name)) as f:
                out[name] = json.load(f)
    return out


def _evaluate(main, d, results, *flags, device=True):
    argv = ["--model-dir", d, "--results-dir", str(results), *flags]
    assert main(argv + (["--device", "cpu"] if device else [])) == 0
    return _read(str(results))


@pytest.fixture(scope="module")
def jax_runs(model_dir, tmp_path_factory):
    """The JAX CLI's outputs, once per run."""
    root = tmp_path_factory.mktemp("jax_eval")
    return {name: _evaluate(jax_evaluate.main, model_dir["dir"], root / name,
                            *flags, device=False)
            for name, flags in RUNS.items()}


def _assert_same(got, want):
    assert set(got) == set(want)
    for name in FILES:
        if name in want:
            assert got[name] == want[name], name
    r, w = got["results.json"], want["results.json"]
    assert set(r) == set(w)
    for k in w:
        assert r[k] == pytest.approx(w[k], abs=1e-9, rel=0), k


@pytest.mark.parametrize("run", list(RUNS))
def test_matches_jax(model_dir, jax_runs, tmp_path, run):
    got = _evaluate(evaluate_iq.main, model_dir["dir"], tmp_path,
                    *RUNS[run])
    _assert_same(got, jax_runs[run])
    assert len(set(got["preds.json"])) >= 4
    assert got["results.json"]["Bleu_4"] > 0.2
    if run == "beam":
        assert "z_samples.json" not in got
    else:
        assert len(got["z_samples.json"]["samples"]) == 2
        assert {"infomax_distinct_rate", "infomax_consistency",
                "Bleu_4"} <= set(got["results.json"])


@pytest.mark.parametrize("data", ["hdf5", "packed"])
def test_datasets_and_test_iq(model_dir, jax_runs, tmp_path, data):
    """Both dataset forms evaluate to the JAX CLI's outputs of the hdf5
    file, and ``test_iq`` writes what ``evaluate_iq`` writes."""
    flags = ["--dataset", model_dir[data], *RUNS["greedy"]]
    got = _evaluate(evaluate_iq.main, model_dir["dir"], tmp_path / "e",
                    *flags)
    _assert_same(got, jax_runs["greedy"])
    assert _evaluate(test_iq.main, model_dir["dir"], tmp_path / "t",
                     *flags) == got


def test_sampled_top1_equals_greedy(model_dir, jax_runs, tmp_path):
    got = _evaluate(evaluate_iq.main, model_dir["dir"], tmp_path,
                    "--decode-sampling", "--decode-top-k", "1")
    assert got["preds.json"] == jax_runs["greedy"]["preds.json"]


def _variant(model_dir, tmp_path, **over):
    """A copy of the model directory with ``over`` set in its args.json."""
    d = str(tmp_path / "model")
    shutil.copytree(model_dir["dir"], d)
    with open(os.path.join(d, "args.json")) as f:
        args = json.load(f)
    args.update(over)
    with open(os.path.join(d, "args.json"), "w") as f:
        json.dump(args, f)
    return d


def test_bf16_grad_dir_evaluates(model_dir, jax_runs, tmp_path):
    """``grad_dtype`` is a training option: evaluation builds no train
    step."""
    d = _variant(model_dir, tmp_path, grad_dtype="bfloat16")
    got = _evaluate(evaluate_iq.main, d, tmp_path / "out", *RUNS["greedy"])
    _assert_same(got, jax_runs["greedy"])


# where the optax chain of fused_adam=False keeps scale_by_adam's state
CHAIN = "opt_state/.inner_states/train/.inner_state/1/"


def _to_chain(directory: str) -> None:
    """Rewrites each step's npz with the fused optimizer state moved to the
    chain's keys (count, mu, nu; the chain has no masters)."""
    root = os.path.join(directory, "checkpoints")
    for step in os.listdir(root):
        path = os.path.join(root, step, "state.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        assert not any(".master/" in k for k in flat)
        out = {}
        for k, v in flat.items():
            if k.replace("__dtype__/", "", 1).startswith(
                    ("opt_state/.count", "opt_state/.mu/", "opt_state/.nu/")):
                k = k.replace("opt_state/", CHAIN, 1)
            out[k] = v
        np.savez(path, **out)


def test_unfused_adam_dir_raises_before_decoding(model_dir, jax_runs,
                                                 tmp_path):
    """A ``fused_adam=False`` directory (chain checkpoints) evaluates to
    the JAX CLI's outputs; the port restores its optimizer state."""
    d = _variant(model_dir, tmp_path, fused_adam=False)
    _to_chain(d)
    got = _evaluate(evaluate_iq.main, d, tmp_path / "out", *RUNS["greedy"])
    _assert_same(got, jax_runs["greedy"])
