"""The port's information-maximization evaluation against the JAX package.

- The framework-free functions of train/infomax.py are the JAX module's
  source, and on seed-made question lists (with and without draws that
  repeat, with the consistency and validity predicates) both give equal
  floats.
- ``multi_z_decode``: under ``decode_z_source="prior_mean"`` every draw is
  deterministic, so the port's k draws equal the JAX package's token for
  token (f32, tiny sizes, weights converted from the JAX model).  Under
  ``prior_sample`` the draws are held to the port's own determinism: the
  same base seed gives the same tokens, and different draws different z.
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu.train import infomax as jinfo
from blt_vqg_tpu.train.state import create_train_state as jax_state
from blt_vqg_tpu.train.step import make_decode_step as jax_decode_step
from blt_vqg_tpu_torch.convert import from_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.train import infomax as tinfo
from blt_vqg_tpu_torch.train.step import make_batch, make_decode_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 50
COPIED = ("_ngrams", "diversity_metrics", "category_word_consistency",
          "mapped_word_consistency", "_norm_question", "template_validity")
TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
            num_layers=2, num_heads=4, max_q_length=10, max_a_length=4,
            max_decode_length=8, dtype="float32", image_size=32,
            input_mode="cat")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _functions(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    return {node.name: ast.get_source_segment(text, node)
            for node in ast.parse(text).body
            if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("name", COPIED)
def test_copy_equals_original(name):
    """Each framework-free function is the JAX module's source."""
    original = _functions("blt_vqg_tpu/train/infomax.py")
    copy = _functions("blt_vqg_tpu_torch/train/infomax.py")
    assert copy[name] == original[name]


class _Vocab:
    def __init__(self, n):
        self.idx2word = {i: f"w{i}" for i in range(n)}


def _questions(r, k, b, words=12, repeat=0.0):
    """k draws for b images of 3-7 random words; with ``repeat`` a share of
    draws copies draw 0 (so distinct rates fall below 1)."""
    draws = [[" ".join(f"w{w}" for w in r.randint(0, words,
                                                  r.randint(3, 8)))
              for _ in range(b)] for _ in range(k)]
    for j in range(1, k):
        for i in range(b):
            if r.rand() < repeat:
                draws[j][i] = draws[0][i]
    return draws


@pytest.mark.parametrize("k,b,repeat", [(1, 5, 0.0), (3, 6, 0.0),
                                        (4, 7, 0.5), (2, 3, 1.0)],
                         ids=["k1", "k3", "k4-repeats", "k2-same"])
def test_diversity_metrics_match_jax(k, b, repeat):
    r = np.random.RandomState(k * 100 + b)
    samples = _questions(r, k, b, repeat=repeat)
    contexts = list(6 + r.randint(0, 6, b))
    refs = [samples[0][i] if r.rand() < 0.5 else "w1 w2" for i in range(b)]
    # "?" glued to the last word, as the corpus writes it
    valid = {"c0": [q + "?" for q in samples[0]],
             "c1": ["w1 w2"]}
    cat2words = {f"w{6 + c}": [f"w{6 + c}"] for c in range(6)}
    got, want = [], []
    for mod, out in ((tinfo, got), (jinfo, want)):
        vocab = _Vocab(20)
        out.append(mod.diversity_metrics(
            samples, contexts=contexts,
            consistent_fn=mod.category_word_consistency(vocab, 0),
            refs=refs, valid_fn=mod.template_validity(valid)))
        out.append(mod.diversity_metrics(
            samples, contexts=contexts,
            consistent_fn=mod.mapped_word_consistency(cat2words,
                                                      vocab.idx2word)))
        out.append(mod.diversity_metrics(samples))
    assert got == want
    assert set(got[0]) >= {"distinct_rate", "distinct_1", "distinct_2",
                           "consistency", "valid_rate", "distinct_valid"}
    assert ("self_bleu" in got[0]) == (k > 1)


@pytest.fixture(scope="module")
def weights():
    """A tiny JAX model's weights and the port model holding them."""
    cfg = Config(**TINY)
    jmodel = JaxIQ(cfg, VOCAB)
    batch = make_batch(cfg, VOCAB, 4, np.random.RandomState(0), "cpu")
    host = {k: v.numpy() for k, v in batch.items()}
    jstate = jax_state(cfg, jmodel, jax.random.key(0), host)
    model = IQ(cfg, VOCAB)
    model.load_state_dict(from_flax(jax.device_get(jstate.params),
                                    jax.device_get(jstate.batch_stats)))
    return cfg, jmodel, jstate, model.eval(), batch, host


def test_multi_z_decode_prior_mean_matches_jax(weights):
    cfg, jmodel, jstate, model, batch, host = weights
    cfg = cfg.replace(decode_z_source="prior_mean")
    jstep = jax_decode_step(cfg, jmodel, latent_mode=True)
    want = jinfo.multi_z_decode(jstep, jstate, host["images"],
                                host["context"], jax.random.key(9), 3)
    got = tinfo.multi_z_decode(make_decode_step(cfg, model, True),
                               batch["images"], batch["context"], 9, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], got[2])


def test_multi_z_decode_prior_sample_is_seeded(weights):
    cfg, _, _, model, batch, _ = weights
    step = make_decode_step(cfg, model, True)
    a = tinfo.multi_z_decode(step, batch["images"], batch["context"], 5, 3)
    b = tinfo.multi_z_decode(step, batch["images"], batch["context"], 5, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the draws' z differ, and so do some of their questions
    zs = []
    enc, _ = model.encode_context(batch["context"],
                                  model.encoder_cnn(batch["images"]))
    with torch.no_grad():
        for j in range(3):
            gen = tinfo.RngStream(5).key(j)
            zs.append(model.z_projection(enc, True, generator=gen))
    assert not torch.equal(zs[0], zs[1]) and not torch.equal(zs[1], zs[2])
    assert any(not np.array_equal(a[0], x) for x in a[1:])
