"""The evaluation decode paths of the port against the JAX package:
``IQ.decode_beam`` (plain and per-layer paths), ``IQ.inference_logits``,
greedy decoding with the posterior z sources, and greedy decoding on the
per-layer path (``use_pallas_decode``), at a tiny size in f32.

The weights are the iq_decode slice's (made in the port from a seed, every
leaf perturbed, carried to JAX with ``convert.to_flax``).  Where JAX draws
the latent noise from its ``latent`` stream, the test reads that draw
(``m.latent.make_rng("latent")`` under the same key) and injects it into
the port as ``eps``.  Tokens must be equal and scores and logits within
1e-5.  Greedy cases also assert that the top-2 logit gap of the path they
ran exceeds 1e-3 at every step, so no near-tie decides a token.  The JAX
per-layer path runs its Pallas kernels in interpret mode.  The streaming
path's beam search is held to the port's own plain path (tokens equal,
scores within 1e-5), which keeps this file within its time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import IQ, PAD
from blt_vqg_tpu_torch.train.step import (make_beam_decode_step,
                                          make_diag_decode_step)
from test_torch_iq_decode import END_BIAS, MAX_DECODE, SEED, TINY, VOCAB
from test_torch_iq_decode import _make_slice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BEAM = 3
PER_LAYER = dict(use_pallas_decode=True)
KEY = jax.random.key(7)


@pytest.fixture(scope="module")
def setup():
    s = _make_slice(SEED, END_BIAS)
    r = np.random.RandomState(SEED + 1)
    b = s["images"].shape[0]
    s["posterior"] = r.randint(1, VOCAB, (b, Config(**TINY).max_posterior_len)
                               ).astype(np.int32)
    s["posterior"][:, -3:] = 0                       # trailing pads
    draw = lambda m: jax.random.normal(m.latent.make_rng("latent"),
                                       (b, TINY["latent_dim"]), jnp.float32)
    s["eps"] = np.array(JaxIQ(JaxConfig(**TINY), VOCAB).apply(
        s["variables"], method=draw, rngs={"latent": KEY}))
    return s


def _port(cfg_over, state):
    model = IQ(Config(**TINY, **cfg_over), VOCAB)
    model.load_state_dict(state)
    return model.eval()


def _jax(s, cfg_over, method, **kw):
    """The JAX method, compiled as one program (much cheaper than its
    first eager run): array arguments traced, the rest static."""
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    model = JaxIQ(JaxConfig(**TINY, **cfg_over), VOCAB)
    fn = jax.jit(lambda v, images, context, arrays: model.apply(
        v, images, context, method=method, rngs={"latent": KEY}, **static,
        **arrays))
    return fn(s["variables"], s["images"], s["context"], arrays)


def _inputs(s):
    return torch.from_numpy(s["images"]), torch.from_numpy(s["context"])


@pytest.mark.parametrize("cfg_over,latent_mode", [
    ({}, False), ({}, True), (PER_LAYER, True)],
    ids=["plain", "plain-latent", "per-layer-latent"])
def test_decode_beam_matches_jax(setup, cfg_over, latent_mode):
    s = setup
    want = _jax(s, cfg_over, JaxIQ.decode_beam, beam_size=BEAM,
                max_decode_length=MAX_DECODE, latent_mode=latent_mode)
    model = _port(cfg_over, s["state"])
    with torch.inference_mode():
        got = model.decode_beam(*_inputs(s), beam_size=BEAM,
                                max_decode_length=MAX_DECODE,
                                latent_mode=latent_mode,
                                eps=torch.from_numpy(s["eps"]))
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5,
                               rtol=1e-5)


def test_stream_beam_matches_plain_path(setup):
    s = setup
    eps = torch.from_numpy(s["eps"])
    out = {}
    for name, over in (("plain", {}), ("stream", dict(use_stream_decode=True))):
        model = _port(over, s["state"])
        assert model.decoder.cache_batch_axis == (3 if over else 0)
        with torch.inference_mode():
            out[name] = model.decode_beam(*_inputs(s), beam_size=BEAM,
                                          max_decode_length=MAX_DECODE,
                                          latent_mode=True, eps=eps)
    np.testing.assert_array_equal(out["stream"]["tokens"].numpy(),
                                  out["plain"]["tokens"].numpy())
    np.testing.assert_allclose(out["stream"]["scores"].numpy(),
                               out["plain"]["scores"].numpy(), atol=1e-5,
                               rtol=1e-5)


def test_top_k_ties_go_to_the_lower_index():
    from blt_vqg_tpu_torch.models.iq import _top_k
    x = torch.tensor([[0.5, 2.0, 1.0, 2.0, 2.0, -1.0]])
    values, idx = _top_k(x, 4)
    assert idx.tolist() == [[1, 3, 4, 2]]
    assert values.tolist() == [[2.0, 2.0, 2.0, 1.0]]


def test_inference_logits_matches_jax(setup):
    s = setup
    r = np.random.RandomState(3)
    prefix = r.randint(1, VOCAB, (s["images"].shape[0], 6)).astype(np.int32)
    want = _jax(s, {}, JaxIQ.inference_logits, prefix=prefix,
                latent_mode=True)
    model = _port({}, s["state"])
    with torch.inference_mode():
        got = model.inference_logits(*_inputs(s), torch.from_numpy(prefix),
                                     latent_mode=True,
                                     eps=torch.from_numpy(s["eps"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _top2_gaps(model, plan, tokens):
    """Teacher-forced replay of ``tokens`` through the port's decoder on
    the plan's path: the top-2 logit gap [B, L] of every step."""
    b, steps = tokens.shape
    caches = model.decoder.init_cache(b, steps)
    token = torch.full((b,), PAD, dtype=torch.int32)
    gaps = []
    for pos in range(steps):
        x_t = model.embed_tokens(token[:, None])
        if pos == 0:
            x_t = x_t + plan["inject"][:, None]
        y, _ = model.decoder.step(x_t, caches, plan["cross_kvs"], pos,
                                  plan["src_mask"], layers=plan["layers"])
        top2 = model.output_proj(y[:, 0].float()).topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        token = tokens[:, pos]
    return torch.stack(gaps, dim=1)


GREEDY_CASES = {
    "posterior_sample": ({}, dict(z_source="posterior_sample")),
    "posterior_mean": ({}, dict(z_source="posterior_mean")),
    "per-layer-probe": (PER_LAYER, dict(z_source="prior_sample",
                                        with_probe=True)),
    "per-layer-early-stop": (PER_LAYER, dict(z_source="prior_mean",
                                             early_stop=True)),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_decode_greedy_matches_jax(setup, case):
    cfg_over, kw = GREEDY_CASES[case]
    kw = dict(dict(latent_mode=True, with_probe=False), **kw)
    s = setup
    post = kw["z_source"].startswith("posterior")
    want = _jax(s, cfg_over, JaxIQ.decode_greedy,
                max_decode_length=MAX_DECODE,
                posterior=s["posterior"] if post else None, **kw)
    model = _port(cfg_over, s["state"])
    posterior = torch.from_numpy(s["posterior"]) if post else None
    eps = torch.from_numpy(s["eps"])
    with torch.inference_mode():
        got = model.decode_greedy(*_inputs(s), max_decode_length=MAX_DECODE,
                                  posterior=posterior, eps=eps, **kw)
        plan = model.prepare_decode(*_inputs(s), MAX_DECODE, True,
                                    kw["with_probe"], kw["z_source"],
                                    posterior=posterior, eps=eps)
        assert (plan["layers"] is not None) == bool(cfg_over)
        tokens = got["tokens"]
        gaps = _top2_gaps(model, plan, tokens)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want["tokens"]))
    ended = (tokens == 3).int().cumsum(dim=1) > 0
    chose = torch.ones_like(tokens, dtype=torch.bool)
    if kw.get("early_stop"):
        chose[:, 1:] = ~ended[:, :-1]
    assert float(gaps[chose].min()) > 1e-3
    if kw["with_probe"]:
        np.testing.assert_array_equal(got["top_tokens"].numpy(),
                                      np.asarray(want["top_tokens"]))
        np.testing.assert_allclose(got["top_probs"].numpy(),
                                   np.asarray(want["top_probs"]),
                                   atol=1e-5, rtol=1e-5)


def test_posterior_source_needs_posterior(setup):
    model = _port({}, setup["state"])
    with torch.inference_mode(), pytest.raises(ValueError, match="posterior"):
        model.decode_greedy(*_inputs(setup), max_decode_length=2,
                            latent_mode=True, z_source="posterior_mean")


def test_decode_step_factories(setup):
    """``make_beam_decode_step``, ``make_diag_decode_step`` and
    ``predict_from_category`` decode as the model methods they wrap."""
    s = setup
    cfg = Config(**TINY, beam_size=BEAM)
    model = _port({}, s["state"])
    images, context = _inputs(s)
    posterior = torch.from_numpy(s["posterior"])

    def g():
        return torch.Generator().manual_seed(2)

    beam = make_beam_decode_step(cfg, model, latent_mode=True)(images,
                                                               context, g())
    diag = make_diag_decode_step(cfg, model, "posterior_mean")(
        images, context, posterior)
    with torch.inference_mode():
        want_beam = model.decode_beam(images, context, BEAM, MAX_DECODE,
                                      latent_mode=True, generator=g())
        want_diag = model.decode_greedy(images, context, MAX_DECODE,
                                        latent_mode=True, with_probe=False,
                                        z_source="posterior_mean",
                                        posterior=posterior)
        by_cat = model.predict_from_category(images, context[:, 1],
                                             MAX_DECODE, generator=g())
        want_cat = model.decode_greedy(images, context[:, 1:2], MAX_DECODE,
                                       latent_mode=True, generator=g())
    for got, want in ((beam, want_beam), (diag, want_diag),
                      (by_cat, want_cat)):
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
