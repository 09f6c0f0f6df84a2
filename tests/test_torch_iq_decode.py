"""The serving slice as a whole: ``IQ.decode_greedy`` of the PyTorch port
against the JAX package on the same weights and inputs.

The weights are made in the port from a seed (with the norm parameters,
batch-norm statistics and biases perturbed from numpy so that every leaf
matters), carried to JAX with ``convert.to_flax``, and both packages
decode the same numpy-made requests in f32 at a tiny size.  Tokens must be
equal.  To keep a near-tie from deciding a token, every test also asserts
that the top-2 logit gap of the path it ran exceeds 1e-3 at every step
that chose a token.  The JAX streaming path runs its Pallas kernels in
interpret mode, as the JAX package's own tests do on the CPU.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_vqg_tpu.core.checkpoint import CheckpointManager
from blt_vqg_tpu.core.config import Config as JaxConfig
from blt_vqg_tpu.models.iq import IQ as JaxIQ
from blt_vqg_tpu_torch import serve
from blt_vqg_tpu_torch.convert import to_flax
from blt_vqg_tpu_torch.core.config import Config
from blt_vqg_tpu_torch.models.iq import END, IQ, PAD
from blt_vqg_tpu_torch.ops.kernels.decode_head import head_logits_ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB, BATCH, MAX_DECODE = 50, 4, 8
TINY = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
            num_layers=2, num_heads=4, max_q_length=10, max_a_length=4,
            max_decode_length=MAX_DECODE, attention_dropout=0.0,
            relu_dropout=0.0, dtype="float32", image_size=32,
            input_mode="cat")
# raises the <end> logit so that every row ends inside the decode window
# and the early-stop loop really exits early
END_BIAS = 2.0
SEED = 5
STREAM_H8 = dict(use_stream_decode=True, stream_head_dtype="int8")
CASES = {
    "a_plain": ({}, dict(latent_mode=False, with_probe=False)),
    "b_prior_mean": ({}, dict(latent_mode=True, with_probe=False,
                              z_source="prior_mean")),
    "c_stream_int8_head": (STREAM_H8, dict(latent_mode=True,
                                           with_probe=False,
                                           z_source="prior_mean")),
    "d_early_stop": (STREAM_H8, dict(latent_mode=True, with_probe=False,
                                     z_source="prior_mean",
                                     early_stop=True)),
    "e_probe": ({}, dict(latent_mode=False, with_probe=True)),
}


def _make_slice(seed: int, end_bias: float) -> dict:
    model = IQ(Config(**TINY), VOCAB).init_weights(
        torch.Generator().manual_seed(seed))
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:   # norm scales and biases
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(torch.from_numpy(
                    base + 0.1 * r.randn(*p.shape).astype(np.float32)))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    0.1 * r.randn(*buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(
                    (0.5 + r.rand(*buf.shape)).astype(np.float32)))
        model.output_proj.bias[END] += end_bias
    state = model.state_dict()
    params, stats = to_flax(state)
    images = r.rand(BATCH, 32, 32, 3).astype(np.float32)
    context = np.stack([np.ones(BATCH), r.randint(6, VOCAB, BATCH),
                        np.full(BATCH, 3)], axis=1).astype(np.int32)
    return {"state": state, "variables": {"params": params,
                                          "batch_stats": stats},
            "images": images, "context": context}


@pytest.fixture(scope="module")
def slice_setup():
    return _make_slice(SEED, END_BIAS)


def _port(cfg_over, state):
    model = IQ(Config(**TINY, **cfg_over), VOCAB)
    model.load_state_dict(state)
    return model.eval()


def _top2_gaps(model, images, context, tokens, kw):
    """Teacher-forced replay of ``tokens`` through the port's decoder on
    the path ``kw`` selects: the top-2 logit gap [B, L] of every step."""
    plan = model.prepare_decode(images, context, MAX_DECODE,
                                kw["latent_mode"], kw["with_probe"],
                                kw.get("z_source", "prior_sample"))
    caches = model.decoder.init_cache(BATCH, plan["steps"])
    token = torch.full((BATCH,), PAD, dtype=torch.int32)
    head = plan["head"]
    gaps = []
    for pos in range(plan["steps"]):
        x_t = model.embed_tokens(token[:, None])
        if pos == 0:
            x_t = x_t + plan["inject"][:, None]
        y, _ = model.decoder.step(x_t, caches, plan["cross_kvs"], pos,
                                  plan["src_mask"],
                                  skip_final_ln=head is not None,
                                  stream=plan["stream"])
        if head is not None:
            logits = head_logits_ref(y[:, 0], head["ln_scale"],
                                     head["ln_bias"], head["w"], head["b"],
                                     head["scales"])
        else:
            logits = model.output_proj(y[:, 0].float())
        top2 = logits.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        token = tokens[:, pos]
    return torch.stack(gaps, dim=1)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_greedy_matches_jax(slice_setup, case):
    cfg_over, kw = CASES[case]
    s = slice_setup
    jax_cfg = JaxConfig(**TINY, **cfg_over)
    # compiled as one program: much cheaper than the first eager run
    want = jax.jit(lambda v, images, context: JaxIQ(jax_cfg, VOCAB).apply(
        v, images, context, max_decode_length=MAX_DECODE,
        method=JaxIQ.decode_greedy, rngs={"latent": jax.random.key(0)},
        **kw))(s["variables"], s["images"], s["context"])

    model = _port(cfg_over, s["state"])
    assert model.fused_head_engaged(kw["with_probe"]) == (case[0] in "cd")
    images = torch.from_numpy(s["images"])
    context = torch.from_numpy(s["context"])
    with torch.inference_mode():
        got = model.decode_greedy(images, context,
                                  max_decode_length=MAX_DECODE, **kw)
        tokens = got["tokens"]
        gaps = _top2_gaps(model, images, context, tokens, kw)

    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want["tokens"]))
    # steps that chose a token: all of them, or up to each row's <end>
    chose = torch.ones_like(tokens, dtype=torch.bool)
    ended = (tokens == END).int().cumsum(dim=1) > 0
    if kw.get("early_stop"):
        chose[:, 1:] = ~ended[:, :-1]
        assert bool(ended[:, -2].all()), "every row should end early"
        assert bool((tokens[:, -1] == PAD).all())
    assert float(gaps[chose].min()) > 1e-3
    if kw["with_probe"]:
        np.testing.assert_array_equal(got["top_tokens"].numpy(),
                                      np.asarray(want["top_tokens"]))
        np.testing.assert_allclose(got["top_probs"].numpy(),
                                   np.asarray(want["top_probs"]),
                                   atol=1e-5, rtol=1e-5)


def test_serve_restores_jax_model_dir(tmp_path, slice_setup):
    """``serve.py --model-dir``: the JAX trainer's ``args.json`` and npz
    checkpoint restore into the port, which answers request rounds with the
    JAX package's tokens on the streaming path with the int8 fused head.
    The checkpoint sits at the phase boundary (step == num_pretraining_steps),
    so both serve in latent mode; z is the prior mean."""
    s = slice_setup
    jax_cfg = JaxConfig(**TINY, **STREAM_H8, num_pretraining_steps=10,
                        decode_z_source="prior_mean")
    jax_cfg.save(str(tmp_path / "args.json"))
    v = jax.tree_util.tree_map(jnp.asarray, s["variables"])
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"], opt_state={},
                                  step=10, kliter=0)
    CheckpointManager(str(tmp_path / "checkpoints")).save(state, jax_cfg)

    rounds = serve.main(["--model-dir", str(tmp_path), "--batch", str(BATCH),
                         "--rounds", "2", "--stream", "--device", "cpu"])
    kw = dict(latent_mode=True, with_probe=False, z_source="prior_mean")
    model = _port(STREAM_H8, s["state"])
    # the JAX decode compiled once for both rounds
    jax_decode = jax.jit(lambda v, images, context: JaxIQ(jax_cfg, VOCAB).apply(
        v, images, context, max_decode_length=MAX_DECODE,
        method=JaxIQ.decode_greedy, rngs={"latent": jax.random.key(0)}, **kw))
    for r in rounds:
        want = jax_decode(s["variables"], r["images"].numpy(),
                          r["context"].numpy())
        np.testing.assert_array_equal(r["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        with torch.inference_mode():
            gaps = _top2_gaps(model, r["images"], r["context"], r["tokens"],
                              kw)
        assert float(gaps.min()) > 1e-3


def test_decode_weights_built_once_per_model(slice_setup):
    """``prepare_decode`` reuses the model's weight stacks and fused head
    from one request batch to the next, and rebuilds them once the weights
    change, to what a fresh model with those weights builds."""
    s = slice_setup
    model = _port(STREAM_H8, s["state"])
    args = (torch.from_numpy(s["images"]), torch.from_numpy(s["context"]),
            MAX_DECODE, True, False, "prior_mean")
    with torch.inference_mode():
        first = model.prepare_decode(*args)
        second = model.prepare_decode(*args)
    assert second["stream"]["stacks"] is first["stream"]["stacks"]
    assert second["head"] is first["head"]

    other = _make_slice(SEED + 1, END_BIAS)["state"]
    model.load_state_dict(other)
    with torch.inference_mode():
        after = model.prepare_decode(*args)
        fresh = _port(STREAM_H8, other).prepare_decode(*args)
    assert after["head"] is not first["head"]

    def same(got, want):
        if isinstance(want, torch.Tensor):
            return torch.equal(got, want)
        if isinstance(want, (tuple, list)):
            return len(got) == len(want) and all(map(same, got, want))
        return got == want

    for part in ("stream", "head"):
        assert after[part].keys() == fresh[part].keys()
        for key, want in fresh[part].items():
            assert same(after[part][key], want), (part, key)


def test_serve_defaults_to_the_card():
    """``serve`` runs on the CUDA card unless told otherwise, and fails
    clearly where there is none instead of carrying on on the CPU."""
    assert serve.make_parser().parse_args([]).device == "cuda"
    assert serve.make_parser().parse_args(["--device", "cpu"]).device == "cpu"
    assert serve.check_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            serve.build_model(seed=0)
