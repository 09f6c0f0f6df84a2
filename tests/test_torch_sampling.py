"""The port's token-sampling filters and sampled decoding.

- ``filter_logits`` (temperature -> top-k -> top-p) gives the JAX
  package's logits exactly, on the same numpy logits;
- ``top_k=1`` and a temperature near 0 draw the argmax;
- a seeded frequency test: 20,000 draws from one row land on each token
  with the filtered softmax's probability (within 5 standard errors), and
  never on a filtered token;
- ``make_decode_step`` with ``decode_sampling`` decodes, is reproducible
  from its sample generator, and with ``top_k=1`` emits the greedy tokens.

The draws themselves cannot match JAX's bits (a ``torch.Generator`` against
a JAX key), only its distribution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.ops import sampling as jsampling
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ
from blt_vqg_tpu_torch.ops import sampling
from blt_vqg_tpu_torch.train.step import make_decode_step
from test_torch_iq_decode import END_BIAS, MAX_DECODE, SEED, TINY, VOCAB
from test_torch_iq_decode import _make_slice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.9),
    (1.3, 8, 0.8), (0.5, 1, 0.5), (2.0, 49, 0.95)])
def test_filters_equal_jax(temperature, top_k, top_p):
    r = np.random.RandomState(top_k + 100)
    logits = (r.randn(6, 50) * 3.0).astype(np.float32)
    logits[0, 7] = logits[0, 9] = logits[0].max() + 1.0   # a tie at the top
    want = jsampling.filter_logits(jnp.asarray(logits), temperature, top_k,
                                   top_p)
    got = sampling.filter_logits(torch.from_numpy(logits), temperature, top_k,
                                 top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(temperature=1e-6),
                                dict(top_k=1, top_p=0.3, temperature=2.0)])
def test_near_greedy_settings_draw_the_argmax(kw):
    r = np.random.RandomState(1)
    logits = torch.from_numpy((r.randn(16, 50) * 2.0).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        tok = sampling.sample_token(g, logits, **kw)
        assert tok.dtype == torch.int32
        assert torch.equal(tok, logits.argmax(dim=-1).to(torch.int32))


def test_draw_frequencies_follow_the_filtered_softmax():
    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0])
    kw = dict(temperature=0.8, top_k=6, top_p=0.9)
    probs = torch.softmax(sampling.filter_logits(logits[None], **kw), dim=-1)[0]
    n = 20000
    g = torch.Generator().manual_seed(11)
    draws = sampling.sample_token(g, logits[None].expand(n, -1), **kw)
    freq = torch.bincount(draws.long(), minlength=8).double() / n
    se = torch.sqrt(probs.double() * (1 - probs.double()) / n)
    assert bool(((freq - probs.double()).abs() <= 5 * se + 1e-12).all())
    assert bool((freq[probs == 0] == 0).all()) and int((probs == 0).sum()) >= 3


@pytest.fixture(scope="module")
def model_and_inputs():
    s = _make_slice(SEED, END_BIAS)
    model = IQ(Config(**TINY), VOCAB)
    model.load_state_dict(s["state"])
    return (model.eval(), torch.from_numpy(s["images"]),
            torch.from_numpy(s["context"]))


def test_sampled_decode_step(model_and_inputs):
    model, images, context = model_and_inputs
    cfg = Config(**TINY, decode_sampling=True, decode_temperature=0.9,
                 decode_top_k=10, decode_top_p=0.95,
                 decode_z_source="prior_mean")
    step = make_decode_step(cfg, model, latent_mode=True, with_probe=False)
    runs = [step(images, context, torch.Generator().manual_seed(0),
                 torch.Generator().manual_seed(s))["tokens"]
            for s in (3, 3, 4)]
    assert runs[0].shape == (images.shape[0], MAX_DECODE + 1)
    assert bool(((runs[0] >= 0) & (runs[0] < VOCAB)).all())
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="sample_generator"):
        step(images, context, torch.Generator().manual_seed(0))

    greedy = make_decode_step(cfg.replace(decode_sampling=False), model,
                              latent_mode=True, with_probe=False)
    top1 = make_decode_step(cfg.replace(decode_top_k=1), model,
                            latent_mode=True, with_probe=False)
    want = greedy(images, context, torch.Generator().manual_seed(0))
    got = top1(images, context, torch.Generator().manual_seed(0),
               torch.Generator().manual_seed(5))
    assert torch.equal(got["tokens"], want["tokens"])
