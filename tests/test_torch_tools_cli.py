"""The port's tuning and data tooling against the JAX package's.

- train/tune.py is the JAX module's source; ``run_tune`` with the same
  stub trial function gives the JAX trials, rungs, trial files and
  ``analysis.json``; ``cli.tune --parallel 2 --device cpu`` trains two
  tiny trials in child processes of the port, each reporting its rungs.
- ``cli.vocab`` (word and BPE), ``cli.store_dataset`` (train and val
  splits, float and uint8 images) and ``cli.pack_dataset`` write what the
  JAX CLIs write on a small fake-COCO fixture: every array, hdf5
  attribute and JSON file equal in content.
- ``cli.replicate_vqa``: the same preflight problems, and the same
  commands with the JAX module names mapped to the port's.
"""

import json
import os
import random

import h5py
import numpy as np
import pytest
import torch

from blt_vqg_tpu.cli import pack_dataset as jax_pack
from blt_vqg_tpu.cli import replicate_vqa as jax_replicate
from blt_vqg_tpu.cli import store_dataset as jax_store
from blt_vqg_tpu.cli import vocab as jax_vocab
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.train import tune as jax_tune
from blt_vqg_tpu_torch.cli import pack_dataset, replicate_vqa, store_dataset
from blt_vqg_tpu_torch.cli import tune as tune_cli
from blt_vqg_tpu_torch.cli import vocab
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.train import tune
from tests.test_resnet_import import synthetic_state_dict

PIL = pytest.importorskip("PIL.Image")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_vocab, jax_store, jax_pack),
            "port": (vocab, store_dataset, pack_dataset)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tune_copy_equals_original():
    with open(os.path.join(ROOT, "blt_vqg_tpu", "train", "tune.py")) as f:
        original = f.read()
    with open(os.path.join(ROOT, "blt_vqg_tpu_torch", "train",
                           "tune.py")) as f:
        assert f.read() == original


def _read_tree(root: str) -> dict:
    """{relative path: JSON content} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            with open(os.path.join(d, name)) as f:
                out[os.path.relpath(os.path.join(d, name), root)] = \
                    json.load(f)
    return out


@pytest.mark.parametrize("space", ["tiny", "reference"])
def test_run_tune_matches_jax(tmp_path, space):
    """The same base config, stub and seed: the same trials, rung calls,
    trial files and analysis."""
    space_fn = {"tiny": "tiny_search_space",
                "reference": "default_search_space"}[space]
    results = {}
    for name, mod, cfg_cls in (("jax", jax_tune, JaxConfig),
                               ("port", tune, Config)):
        calls = []

        def stub(cfg, trial_dir, stop_at_step, calls=calls):
            calls.append((os.path.basename(trial_dir), stop_at_step,
                          cfg.hidden_dim, cfg.output_dir == trial_dir))
            return float(cfg.lr) * 1e3 + stop_at_step / cfg.hidden_dim
        out = str(tmp_path / name)
        res = mod.run_tune(cfg_cls(num_pretraining_steps=3,
                                   total_training_steps=30), stub,
                           num_samples=5, space=getattr(mod, space_fn)(),
                           seed=3, output_dir=out)
        results[name] = (res, calls, _read_tree(out))
    assert results["port"] == results["jax"]
    res, calls, _ = results["port"]
    assert {c[1] for c in calls} == {3, 9, 27, 30} and all(c[3] for c in calls)
    assert res["best_trial"] in range(5)


def test_sample_config_matches_jax():
    got = tune.sample_config(Config(), tune.default_search_space(),
                             random.Random(1))
    want = jax_tune.sample_config(JaxConfig(),
                                  jax_tune.default_search_space(),
                                  random.Random(1))
    assert got[1] == want[1]
    assert got[0].to_json() == want[0].to_json()


def _write_jpeg(path, color, size=32):
    PIL.fromarray(np.full((size, size, 3), color, np.uint8)).save(path,
                                                                  "JPEG")


@pytest.fixture(scope="module")
def fake_coco(tmp_path_factory):
    """tests/test_store_dataset.py's fixture: train images in both COCO
    name formats and one missing, VQA-style JSON over two categories, a
    val split."""
    root = tmp_path_factory.mktemp("coco")
    img = root / "images"
    img.mkdir()
    _write_jpeg(img / "COCO_train2014_1.jpg", 200)
    _write_jpeg(img / "COCO_train2014_000000000002.jpg", 60)
    _write_jpeg(img / "COCO_val2014_1.jpg", 120)
    questions = {"questions": [
        {"image_id": 1, "question_id": 10, "question": "what color is the cat"},
        {"image_id": 2, "question_id": 20,
         "question": "how many dogs are there"},
        {"image_id": 3, "question_id": 30, "question": "what color is the sky"},
        {"image_id": 1, "question_id": 40, "question": "what animal is shown"},
        {"image_id": 2, "question_id": 50, "question": "what color is the dog"},
    ]}
    annotations = {"annotations": [
        {"image_id": 1, "question_id": 10, "multiple_choice_answer": "red"},
        {"image_id": 2, "question_id": 20, "multiple_choice_answer": "two"},
        {"image_id": 3, "question_id": 30, "multiple_choice_answer": "blue"},
        {"image_id": 1, "question_id": 40, "multiple_choice_answer": "cat"},
        {"image_id": 2, "question_id": 50, "multiple_choice_answer": "red"},
    ]}
    paths = {"img": str(img), "questions": str(root / "questions.json"),
             "annotations": str(root / "annotations.json"),
             "cat2ans": str(root / "cat2ans.json")}
    for key, obj in (("questions", questions), ("annotations", annotations),
                     ("cat2ans", {"count": ["two", "three"],
                                  "color": ["red", "blue"]})):
        with open(paths[key], "w") as f:
            json.dump(obj, f)
    return paths


def _h5_contents(path: str) -> dict:
    out = {}
    with h5py.File(path, "r") as h5:
        out["attrs"] = {k: np.asarray(v).tolist() for k, v in h5.attrs.items()}
        for k in h5.keys():
            out[k] = (h5[k].dtype.str, h5[k][:])
            out[k + "/attrs"] = {a: np.asarray(v).tolist()
                                 for a, v in h5[k].attrs.items()}
    return out


def _assert_same_arrays(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], tuple):
            assert got[k][0] == want[k][0], k
            np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)
        else:
            assert got[k] == want[k], k


def _etl(pkg: str, coco: dict, out, extra=()):
    """cli.vocab, then cli.store_dataset train and val, then
    cli.pack_dataset, of one package into ``out``."""
    vocab_mod, store_mod, pack_mod = PACKAGES[pkg]
    os.makedirs(out)
    common = ["--image-dir", coco["img"], "--questions", coco["questions"],
              "--annotations", coco["annotations"], "--cat2ans",
              coco["cat2ans"], "--vocab-path", str(out / "vocab.json"),
              "--cat2name", str(out / "cat2name.json"), "--im_size", "16",
              "--max-q-length", "8", "--max-a-length", "4", *extra]
    assert vocab_mod.main(["--questions", coco["questions"], "--cat2ans",
                           coco["cat2ans"], "--threshold", "1",
                           "--vocab-path", str(out / "word_vocab.json")]) == 0
    assert vocab_mod.main(["--questions", coco["questions"], "--cat2ans",
                           coco["cat2ans"], "--bpe", "--bpe-vocab-size",
                           "300", "--vocab-path",
                           str(out / "bpe_vocab.json")]) == 0
    assert store_mod.main(common + ["--output", str(out / "train.hdf5")]) == 0
    assert store_mod.main(common + ["--output", str(out / "val.hdf5"),
                                    "--val"]) == 0
    assert pack_mod.main(["--input", str(out / "train.hdf5"), "--output",
                          str(out / "packed")]) == 0


@pytest.mark.parametrize("extra", [(), ("--uint8", "--shard", "0/2"),
                                   ("--tokenizer", "bpe",
                                    "--bpe-vocab-size", "300")],
                         ids=["float", "uint8-shard", "bpe"])
def test_data_clis_match_jax(fake_coco, tmp_path, extra):
    for pkg in PACKAGES:
        _etl(pkg, fake_coco, tmp_path / pkg, extra)
    got, want = tmp_path / "port", tmp_path / "jax"
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    for name in names:
        if name.endswith(".json"):
            with open(got / name) as f, open(want / name) as g:
                assert json.load(f) == json.load(g), name
        elif name.endswith(".hdf5"):
            _assert_same_arrays(_h5_contents(str(got / name)),
                                _h5_contents(str(want / name)))
    packed = sorted(os.listdir(want / "packed"))
    assert sorted(os.listdir(got / "packed")) == packed
    for name in packed:
        a, b = got / "packed" / name, want / "packed" / name
        if name.endswith(".json"):
            # meta.json names the source file, under each package's dir
            with open(a) as f, open(b) as g:
                assert (json.load(f) == json.loads(
                    g.read().replace(str(want), str(got)))), name
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files
                for k in y.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    with h5py.File(got / "train.hdf5", "r") as h5:
        assert h5["questions"].shape[0] > 0


def _fake_vqa_root(tmp_path) -> str:
    """tests/test_replicate_vqa.py's complete data root."""
    root = tmp_path / "vqa"
    for split in ("train2014", "val2014"):
        (root / split).mkdir(parents=True)
        PIL.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
            str(root / split / f"COCO_{split}_000000000001.jpg"))
        with open(root / f"v2_OpenEnded_mscoco_{split}_questions.json",
                  "w") as f:
            json.dump({"questions": [{"image_id": 1, "question_id": 0,
                                      "question": "what is this?"}]}, f)
        with open(root / f"v2_mscoco_{split}_annotations.json", "w") as f:
            json.dump({"annotations": [{"image_id": 1, "question_id": 0,
                                        "multiple_choice_answer": "cat"}]},
                      f)
    with open(root / "iq_dataset.json", "w") as f:
        json.dump({"animal": ["cat", "dog"]}, f)
    return str(root)


def _broken(root, tmp_path, case: str) -> list:
    """Flags for a preflight case; damages ``root`` for some."""
    if case == "missing":
        os.remove(os.path.join(root, "v2_mscoco_val2014_annotations.json"))
        os.remove(os.path.join(root, "iq_dataset.json"))
    elif case == "malformed":
        with open(os.path.join(
                root, "v2_OpenEnded_mscoco_train2014_questions.json"),
                "w") as f:
            json.dump({"wrong": []}, f)
    elif case == "glove":
        bad = tmp_path / "glove.txt"
        bad.write_text("word 0.1 0.2\n")
        return ["--glove", str(bad)]
    elif case in ("resnet", "bad_resnet"):
        ck = str(tmp_path / "resnet18.npz")
        sd = {k: v.numpy() for k, v in synthetic_state_dict().items()}
        if case == "bad_resnet":
            sd.pop("layer4.1.bn2.running_var")
        np.savez(ck, **sd)
        return ["--resnet-ckpt", ck]
    return []


@pytest.mark.parametrize("case", ["complete", "missing", "malformed",
                                  "glove", "resnet", "bad_resnet"])
def test_replicate_preflight_matches_jax(tmp_path, case):
    root = _fake_vqa_root(tmp_path)
    flags = ["--data-root", root, *_broken(root, tmp_path, case)]
    got = replicate_vqa.preflight(replicate_vqa.build_parser().parse_args(
        flags))
    want = jax_replicate.preflight(jax_replicate.build_parser().parse_args(
        flags))
    if case == "bad_resnet":
        # both report the import failure, each in its own words
        assert len(got) == len(want) == 1
        assert got[0].startswith("resnet ckpt failed to import")
        assert want[0].startswith("resnet ckpt failed to import")
    else:
        assert got == want
    assert (got == []) == (case in ("complete", "resnet"))


@pytest.mark.parametrize("flags", [
    [], ["--big", "--pack", "--glove", "g.txt", "--resnet-ckpt", "r.pth"],
    ["--work-dir", "w", "--out", "o", "--steps", "10", "--batch-size", "8",
     "--im-size", "64"]], ids=["default", "big-pack", "overrides"])
def test_replicate_commands_match_jax(flags):
    argv = ["--data-root", "/data/vqa", *flags]
    got = replicate_vqa.build_commands(
        replicate_vqa.build_parser().parse_args(argv))
    want = jax_replicate.build_commands(
        jax_replicate.build_parser().parse_args(argv))
    mapped = [[a.replace("blt_vqg_tpu.cli.", "blt_vqg_tpu_torch.cli.")
               for a in cmd] for cmd in want]
    assert got == mapped
    assert all(c[1].startswith("blt_vqg_tpu_torch.cli.") for c in got)


def test_tune_cli_parallel_children(tmp_path):
    """Two tiny trials as child processes on the CPU: each reaches its
    rungs through the port's train loop and the analysis names the best."""
    from blt_vqg_tpu_torch.data.synthetic import write_synthetic_hdf5
    from blt_vqg_tpu_torch.text.vocabulary import Vocabulary
    v = Vocabulary()
    for i in range(40 - len(v)):
        v.add_word(f"w{i}")
    v.save(str(tmp_path / "vocab.json"))
    h5 = write_synthetic_hdf5(str(tmp_path / "d.hdf5"), num_questions=16,
                              num_images=4, im_size=16, vocab_size=40)
    out = tmp_path / "tune"
    # the children skip the metric writer's optional TensorBoard sink, whose
    # import (TensorFlow) takes seconds per process
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    assert tune_cli.main([
        "--dataset", h5, "--val_dataset", h5, "--vocab",
        str(tmp_path / "vocab.json"), "--image_size", "16", "--emb_dim", "8",
        "--max_q_length", "10", "--max_decode_length", "4",
        "--num_pretraining_steps", "2", "--total_training_steps", "4",
        "--limit_val_batches", "1", "--val_check_interval", "100",
        "--dtype", "float32", "--tune-space", "tiny", "--num-samples", "2",
        "--parallel", "2", "--tune-dir", str(out), "--device", "cpu",
        "--trial-env", "OMP_NUM_THREADS=1",
        "--trial-env", f"PYTHONPATH={tmp_path / 'site'}"]) == 0
    with open(out / "analysis.json") as f:
        analysis = json.load(f)
    assert analysis["best_trial"] in (0, 1)
    for t in analysis["trials"]:
        assert t["step"] in (2, 4) and np.isfinite(t["metric"])
        with open(out / f"trial_{t['id']}" / f"result_{t['step']}.json") as f:
            assert json.load(f)["step"] == t["step"]
    assert any(t["step"] == 4 for t in analysis["trials"])
    assert os.path.exists(out / "trial_0" / "checkpoints")
