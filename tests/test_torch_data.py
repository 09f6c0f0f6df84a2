"""The port's data path and copied host modules against the JAX package.

- The loader: ``make_loader(device=False)`` yields batches equal to the JAX
  ``_host_batches`` for the same seed (shuffled and weighted, over the
  hdf5 and the packed dataset, two epochs), and the prefetcher hands the
  same batches over as tensors on the CPU.
- Augmentation: the eval augment and ``_batched_crop_resize`` on the same
  boxes match the JAX package's jitted functions within 1e-5 (absolute,
  on values of magnitude about 2); hypothesis cases check the crop
  sampler's area and aspect bounds.
- The native IO library builds into the port's build directory and its
  entry points equal the numpy versions.
- The copied modules (text/, data/dataset, packed, synthetic,
  core/metrics, train/nlg_metrics, meteor, meteor_data) are the JAX
  package's source with only the import lines rewritten, and the NLG
  scores of both packages are equal on a few sentence pairs.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from blt_vqg_tpu.data import augment as jaug
from blt_vqg_tpu.data.dataset import IQDataset as JaxIQDataset
from blt_vqg_tpu.data.loader import _host_batches as jax_host_batches
from blt_vqg_tpu.data.packed import PackedDataset as JaxPackedDataset
from blt_vqg_tpu.data.synthetic import write_synthetic_hdf5
from blt_vqg_tpu.text.vocabulary import Vocabulary as JaxVocabulary
from blt_vqg_tpu.train.nlg_metrics import NLGEval as JaxNLGEval
from blt_vqg_tpu_torch.data import augment as taug
from blt_vqg_tpu_torch.data import native
from blt_vqg_tpu_torch.data.dataset import (IQDataset, _drop_first_token,
                                            _insert_at_1)
from blt_vqg_tpu_torch.data.loader import make_loader
from blt_vqg_tpu_torch.data.packed import PackedDataset, pack_hdf5
from blt_vqg_tpu_torch.text.vocabulary import Vocabulary
from blt_vqg_tpu_torch.train.nlg_metrics import NLGEval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG_TOL = 1e-5
# the copied modules, by path under each package
COPIES = ("text/vocabulary.py", "text/tokenizer.py", "text/build.py",
          "text/glove.py", "text/bpe.py", "data/dataset.py",
          "data/synthetic.py", "data/packed.py", "core/metrics.py",
          "train/nlg_metrics.py", "train/meteor.py", "train/meteor_data.py")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vocab(cls, n=40):
    v = cls()
    for i in range(n - len(v)):
        v.add_word(f"w{i}")
    return v


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    h5 = write_synthetic_hdf5(str(root / "train.hdf5"), num_questions=29,
                              num_images=7, im_size=12, vocab_size=40,
                              seed=3)
    packed = pack_hdf5(h5, str(root / "packed"))
    jv, tv = _vocab(JaxVocabulary), _vocab(Vocabulary)
    return {"hdf5": (JaxIQDataset(h5, jv), IQDataset(h5, tv)),
            "packed": (JaxPackedDataset(packed, jv), PackedDataset(packed,
                                                                   tv))}


@pytest.mark.parametrize("kind", ["hdf5", "packed"])
@pytest.mark.parametrize("sampling", ["shuffle", "weighted"])
def test_host_batches_match_jax(datasets, kind, sampling):
    jds, tds = datasets[kind]
    weights = (np.random.RandomState(5).rand(len(tds)) + 0.1
               if sampling == "weighted" else None)
    want = jax_host_batches(jds, 8, "ans", shuffle=True, seed=11,
                            drop_remainder=True, epochs=2,
                            sample_weights=weights)
    got = make_loader(tds, 8, "ans", shuffle=True, seed=11, epochs=2,
                      device=False, sample_weights=weights)
    n = 0
    for w, g in zip(want, got, strict=True):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        n += 1
    assert n == 2 * (len(tds) // 8)


def test_prefetcher_hands_over_tensors(datasets):
    _, tds = datasets["packed"]
    host = list(make_loader(tds, 8, "cat", shuffle=False, epochs=1,
                            device=False))
    it = make_loader(tds, 8, "cat", shuffle=False, epochs=1, device="cpu",
                     prefetch_depth=1)
    got = list(it)
    assert len(got) == len(host)
    for g, h in zip(got, host):
        for k in h:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), h[k], err_msg=k)
    # an infinite stream stops when closed
    inf = make_loader(tds, 8, "cat", device="cpu", prefetch_depth=1)
    next(inf)
    inf.close()
    # multihost slicing: one process holds the whole batch
    host = next(make_loader(tds, 8, "cat", device=False, multihost=True))
    assert len(host["target"]) == 8
    with pytest.raises(ValueError, match="batch shards"):
        make_loader(tds, 7, multihost=True, mesh=_FourShards())


@pytest.fixture(scope="module")
def jax_augment():
    """The JAX functions, jitted once."""
    return {"crop": jax.jit(jaug._batched_crop_resize, static_argnums=5),
            "eval": jaug.make_augment_fn(20, train=False)}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_eval_augment_matches_jax(jax_augment, dtype):
    r = np.random.RandomState(0)
    images = r.randint(0, 256, (3, 13, 13, 3))
    images = (images.astype(np.uint8) if dtype == "uint8"
              else images.astype(np.float32))
    want = np.asarray(jax_augment["eval"](images, jax.random.key(0)))
    got = taug.make_augment_fn(20, train=False)(torch.from_numpy(images))
    assert got.shape == (3, 20, 20, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_TOL)


def test_crop_resize_matches_jax(jax_augment):
    r = np.random.RandomState(1)
    x = r.rand(4, 16, 16, 3).astype(np.float32)
    h = r.uniform(8, 16, 4).astype(np.float32)
    w = r.uniform(8, 16, 4).astype(np.float32)
    y0 = (r.rand(4) * (16 - h)).astype(np.float32)
    x0 = (r.rand(4) * (16 - w)).astype(np.float32)
    want = np.asarray(jax_augment["crop"](x, y0, x0, h, w, 11))
    got = taug._batched_crop_resize(
        *(torch.from_numpy(a) for a in (x, y0, x0, h, w)), 11)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_TOL)


@settings(max_examples=25, deadline=None)
@given(lo=st.floats(0.05, 1.5), span=st.floats(0.0, 0.5),
       r_lo=st.floats(0.3, 1.0), r_span=st.floats(0.0, 2.0),
       seed=st.integers(0, 2 ** 31 - 1))
def test_crop_boxes_within_bounds(lo, span, r_lo, r_span, seed):
    size, batch = 32, 64
    scale, ratio = (lo, lo + span), (r_lo, r_lo + r_span)
    g = torch.Generator().manual_seed(seed)
    y0, x0, h, w = taug._sample_crop_boxes(g, batch, size, scale, ratio)
    eps = 1e-4
    assert bool(((h >= 8.0) & (h <= size) & (w >= 8.0) & (w <= size)).all())
    assert bool(((y0 >= 0) & (x0 >= 0)).all())
    assert bool(((y0 + h <= size + eps) & (x0 + w <= size + eps)).all())
    # where neither side was clamped, the box has the sampled area fraction
    # and aspect ratio
    free = (h > 8.0) & (h < size) & (w > 8.0) & (w < size)
    area = (h * w / size ** 2)[free]
    aspect = (w / h)[free]
    assert bool(((area >= scale[0] * (1 - eps))
                 & (area <= scale[1] * (1 + eps))).all())
    assert bool(((aspect >= ratio[0] * (1 - eps))
                 & (aspect <= ratio[1] * (1 + eps))).all())


def test_train_augment_follows_its_generator():
    images = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (5, 24, 24, 3)).astype(np.uint8))
    aug = taug.make_augment_fn(16, train=True)
    a = aug(images, torch.Generator().manual_seed(7))
    b = aug(images, torch.Generator().manual_seed(7))
    c = aug(images, torch.Generator().manual_seed(8))
    assert a.shape == (5, 16, 16, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())


def test_native_library_builds_and_matches_numpy():
    assert native.available(), "g++ build of native/vqg_io.cc failed"
    path = native.library_path()
    assert path.startswith(native.BUILD) and os.path.exists(path)
    r = np.random.RandomState(0)
    src = r.randint(0, 255, (30, 6, 6, 3)).astype(np.uint8)
    idx = r.randint(0, 30, 11)
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    np.testing.assert_array_equal(native.u8_to_f32(src, 0.5),
                                  src.astype(np.float32) * 0.5)
    rows = r.randint(6, 40, (9, 10)).astype(np.int32)
    rows[np.arange(9), r.randint(1, 10, 9)] = 3
    ins = r.randint(6, 14, 9).astype(np.int32)
    np.testing.assert_array_equal(
        native.token_surgery(rows, 3, 0, ins),
        _insert_at_1(_drop_first_token(rows, 3), ins))
    p = rows.copy()
    p[:, 0] = 5
    np.testing.assert_array_equal(
        native.make_posterior(rows, 5, 3, 0, ins),
        _insert_at_1(_drop_first_token(p, 3), ins))


_IMPORT = re.compile(r"^\s*(from\s+\S+\s+import\b|import\s)")


def _without_h5py_imports(text: str) -> str:
    return "\n".join(ln for ln in text.split("\n")
                     if ln.strip() != "import h5py")


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_original(path):
    """The JAX module with its package imports pointed at the port is the
    port's module (the port imports h5py inside the function that opens a
    file, so that line is left out of both)."""
    with open(os.path.join(ROOT, "blt_vqg_tpu", path)) as f:
        original = f.read()
    with open(os.path.join(ROOT, "blt_vqg_tpu_torch", path)) as f:
        copy = f.read()
    rewritten = "\n".join(
        ln.replace("blt_vqg_tpu.", "blt_vqg_tpu_torch.")
        if _IMPORT.match(ln) else ln for ln in original.split("\n"))
    assert _without_h5py_imports(copy) == _without_h5py_imports(rewritten)


def test_nlg_scores_match_jax():
    refs = ["what color is the cat", "how many people are in the room",
            "is the man holding an umbrella", "what is on the table"]
    hyps = ["what color is the dog", "how many people are there",
            "is the man holding a kite", "what is the table made of"]
    want = JaxNLGEval(no_glove=True, no_skipthoughts=True).compute_metrics(
        ref_list=[refs], hyp_list=hyps)
    got = NLGEval(no_glove=True, no_skipthoughts=True).compute_metrics(
        ref_list=[refs], hyp_list=hyps)
    assert set(got) == set(want) >= {"Bleu_1", "Bleu_4", "METEOR", "ROUGE_L",
                                     "CIDEr"}
    assert got == want


class _FourShards:
    """A stand-in mesh of 4 batch shards (this process the first)."""

    across_processes = True

    def batch_coord(self):
        return 0, 4
