"""The ``seq`` ring across processes and GPipe, on the port's point-to-point
transport (``parallel/mesh.py`` ``ProcessRing``, ``parallel/pipeline.py``),
against the one-process port and the JAX package.

One spawn of 4 gloo ranks for the whole file (``torch_p2p_worker.py``, no
jax in the children, one torch thread each) runs every scenario; the JAX
references are computed here meanwhile.

- The transport: a channel's double-buffered slots on seq 4 (blocks seen
  at each step in both directions, a bool payload, the direct return into
  ``out`` two hops away), ``permute`` and its gradient (sent back the
  other way), its byte count.
- Rows 6a-6d's plain versions (the one-way and two-way forward and
  backward shard functions) on process ranks: each rank holds its own
  shard and runs its own entries of the plan; the ranks' outputs, put
  together, match JAX's XLA ring on host devices (the cases of
  tests/test_torch_ring_attention.py: n = 4 with pads and with a dead row,
  n = 2 on the seq rings of data 2 x seq 2; 1e-5 of each tensor's scale).
- The sequence-parallel train step (pretrain step, Adam reset, latent step,
  latent eval step; the two-way ring) on seq 4, seq 2 x data 2 and seq 2 x
  model 2 (each rank's heads ring) against the one-process ``LocalRing``
  step, and GPipe on pipe 2 x data 2
  (two microbatches, deterministic) against the one-process step: rtol
  2e-4 / atol 1e-5 (batch-norm statistics atol 1e-6), as
  tests/test_torch_parallel.py holds its steps.
- ``pipeline_apply`` forward and gradients against the sequential stack
  for (stages, microbatches) (2, 2), (2, 4), (4, 4) and pipe 2 x data 2,
  at JAX tests/test_pipeline.py's limits (forward rtol 1e-5 / atol 1e-6,
  gradients rtol 1e-4 / atol 1e-5); dropout noise bit-equal for 1, 2 and
  4 stages; the validation errors.
- The pipelined ``TransformerDecoder`` (data 2 x pipe 2, deterministic)
  against the JAX pipelined decoder on the same weights: its output, and
  the gradients of sum(out^2) on pipe 2 (JAX's limits, 1e-5 and 1e-4).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as pworker
import torch_p2p_worker as worker
from blt_vqg_tpu.ops.transformer import TransformerDecoder as JaxDecoder
from blt_vqg_tpu.parallel.mesh import build_mesh as jax_build_mesh
from blt_vqg_tpu_torch.convert import to_flax
from blt_vqg_tpu_torch.ops.transformer import TransformerDecoder
from blt_vqg_tpu_torch.parallel.mesh import (LocalRing, Mesh, build_mesh)
from blt_vqg_tpu_torch.parallel.pipeline import pipeline_apply
from test_torch_ring_attention import _inputs as ring_inputs
from test_torch_ring_attention import _want as ring_want
from test_torch_ring_attention import assert_close

WORLD, JOIN_S = 4, 240
SCENARIOS = (["protocol"] + [f"shards_{c}" for c in worker.SHARD_CASES]
             + list(worker.SEQ_STEPS) + ["pipe_step", "pipe_apply",
                                         "pipe_dropout", "pipe_decoder"])
DEC_KW = dict(hidden_dim=32, num_layers=4, num_heads=4, pwffn_dim=64,
              attention_dropout=0.0, relu_dropout=0.0, max_decode_len=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoder_inputs():
    """The port decoder's seed-made weights and the decoder's inputs."""
    dec = TransformerDecoder(**DEC_KW, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    r = np.random.RandomState(0)
    x = r.randn(8, 6, 32).astype(np.float32)
    enc = r.randn(8, 3, 32).astype(np.float32)
    src = np.zeros((8, 1, 1, 3), bool)
    src[..., 2:] = True
    return dec, x, enc, src


def _jax_decoder(dec, x, enc, src):
    """The JAX pipelined decoder: its output on data 2 x pipe 2, and the
    gradients of sum(out^2) on pipe 2 (JAX tests/test_pipeline.py)."""
    params, _ = to_flax(dec.state_dict())
    kw = dict(DEC_KW, dtype=jnp.float32)
    mesh = jax_build_mesh((2, 2), ("data", "pipe"),
                          devices=jax.devices()[:4])
    fwd = JaxDecoder(**kw, pipeline_stages=2, pipeline_microbatches=2,
                     pipeline_mesh=mesh)
    out = jax.jit(lambda p: fwd.apply({"params": p}, x, enc, src, None,
                                      True))(params)
    piped = JaxDecoder(**kw, pipeline_stages=2, pipeline_microbatches=2,
                       pipeline_mesh=jax_build_mesh(
                           (2,), ("pipe",), devices=jax.devices()[:2]))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(piped.apply(
        {"params": p}, x, enc, None, None, True) ** 2)))(params)
    return np.asarray(out), grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eight_devices):
    out = str(tmp_path_factory.mktemp("p2p"))
    arrays = {}
    for case in worker.SHARD_CASES:
        for name, x in zip(("q", "k", "v", "pad", "do"), ring_inputs(case)):
            arrays[f"{case}/{name}"] = x
    dec, x, enc, src = _decoder_inputs()
    arrays.update({"dec/" + k: v.numpy() for k, v in dec.state_dict().items()})
    arrays.update({"decin/x": x, "decin/enc": enc, "decin/src_mask": src})
    np.savez(os.path.join(out, "inputs.npz"), **arrays)
    procs = pworker.start(out, [], WORLD, args=[
        os.path.abspath(worker.__file__), out, *SCENARIOS])
    jax_ring = {case: ring_want(case) for case in worker.SHARD_CASES}
    jax_dec = _jax_decoder(dec, x, enc, src)
    runs = pworker.join(procs, JOIN_S)
    return {"dir": out, "runs": runs, "ring": jax_ring, "dec": jax_dec,
            "dec_names": [n for n, _ in dec.named_parameters()]}


def _result(ranks, name, rank):
    path = os.path.join(ranks["dir"], f"{name}.r{rank}.json")
    if not os.path.exists(path):
        rc, text = ranks["runs"][rank]
        pytest.fail(f"rank {rank} wrote no {name} result (exit {rc}):\n"
                    f"{text[-3000:]}")
    with open(path) as f:
        out = json.load(f)
    assert "error" not in out, out.get("error")
    return out


# ---------------------------------------------------------------------------
# the transport

def test_process_ring_protocol(ranks):
    n = 4
    for r in range(WORLD):
        out = _result(ranks, "protocol", r)
        assert (out["kind"], out["rank"], out["held"]) == ("ProcessRing", r,
                                                           1)
        assert out["members"] == list(range(n))
        for d in (+1, -1):
            assert out[f"seen_{d}"] == [(r - s * d) % n for s in range(n)]
            assert out[f"home_{d}"] == (r - 2 * d) % n
        assert out["flags_ok"]
        # permute(x, 1): rank r - 1's block; its gradient, rank r + 1's w
        assert out["permute"] == [float((r - 1) % n)] * 3
        assert out["permute_grad"] == [10.0 * ((r + 1) % n) + i
                                       for i in range(3)]
        assert out["permute_bytes"] == 2 * 3 * 4    # forward and backward


def test_build_mesh_refuses_what_no_step_runs():
    with pytest.raises(ValueError, match="expert"):
        build_mesh((2, 2), ("seq", "expert"), device="cpu")
    with pytest.raises(ValueError, match="batch axes"):
        build_mesh((2, 2), ("model", "pipe"), device="cpu")
    with pytest.raises(ValueError, match="batch axes"):
        build_mesh((2, 2), ("seq", "pipe"), device="cpu")
    # seq alone in a world of one process: the shards stay in it
    assert isinstance(build_mesh((4,), ("seq",), device="cpu").ring(),
                      LocalRing)
    with pytest.raises(RuntimeError, match="not initialised"):
        build_mesh((2, 2), ("data", "seq"), device="cpu")


# ---------------------------------------------------------------------------
# the shard functions on process ranks

@pytest.mark.parametrize("case", list(worker.SHARD_CASES))
def test_ring_shards_on_process_ranks_match_jax(ranks, case):
    shape, names = worker.SHARD_CASES[case]
    n = dict(zip(names, shape))["seq"]
    want = dict(zip(("o", "dq", "dk", "dv"), ranks["ring"][case]))
    for group in range(WORLD // n):       # each ring of the world
        parts = {}
        for s in range(n):
            r = group * n + s
            out = _result(ranks, f"shards_{case}", r)
            assert out["residuals_agree"] == [True, True], out
            assert out["launches"] == [0, 0]         # plain versions
            with np.load(os.path.join(ranks["dir"],
                                      f"shards_{case}.r{r}.npz")) as z:
                for k in z.files:
                    parts.setdefault(k, []).append(z[k])
        for tag in ("one", "bidir"):
            for name, w in want.items():
                got = np.concatenate(parts[f"{tag}/{name}"], axis=1)
                assert_close(got, w, f"{case} ring {group} {tag} {name}")


# ---------------------------------------------------------------------------
# the train steps

def _assert_within(out, what):
    worst = {**{f"metric {k}": v for k, v in out["metrics"].items()},
             **{f"eval {k}": v for k, v in out["eval"].items()},
             "parameters": out["params"], "batch-norm statistics": out["bn"],
             "optimizer state": out["opt"]}
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    assert not bad, f"{what}: over the limits (in units of atol): {bad}"
    assert out["step"] == out["ref_step"], what


@pytest.mark.parametrize("name", list(worker.SEQ_STEPS))
def test_seq_steps_match_the_local_ring(ranks, name):
    for r in range(WORLD):
        out = _result(ranks, name, r)
        _assert_within(out, f"{name} rank {r}")
        kind, n, hopped = out["ring"]
        assert kind == "ProcessRing" and hopped, out["ring"]


def test_pipe_step_matches_one_process(ranks):
    for r in range(WORLD):
        _assert_within(_result(ranks, "pipe_step", r), f"pipe rank {r}")


# ---------------------------------------------------------------------------
# pipeline_apply

@pytest.mark.parametrize("case", list(worker.PIPE_CASES))
def test_pipeline_apply_matches_sequential(ranks, case):
    for r in range(WORLD):
        errs = _result(ranks, "pipe_apply", r)[case]
        bad = {k: v for k, v in errs.items() if not v <= 1.0}
        assert not bad, f"{case} rank {r}: over the limits: {bad}"


def test_pipeline_dropout_is_stage_count_invariant(ranks):
    for r in range(WORLD):
        out = _result(ranks, "pipe_dropout", r)
        assert out == {"equal_1_2": True, "equal_1_4": True,
                       "differs_from_other_draws": True}, (r, out)


def test_pipeline_validation_errors():
    layer = lambda i, x, bargs, gen: x
    mesh = Mesh({"pipe": 2}, "cpu")
    x = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_apply(layer, [()] * 3, x, mesh, microbatches=2)
    with pytest.raises(ValueError, match="microbatch"):
        pipeline_apply(layer, [()] * 4, x, mesh, microbatches=3)
    with pytest.raises(ValueError, match="axis"):
        pipeline_apply(layer, [()] * 4, x, Mesh({"data": 2}, "cpu"),
                       microbatches=2)
    dec = TransformerDecoder(**DEC_KW, dtype=torch.float32,
                             pipeline_stages=2)
    with pytest.raises(ValueError, match="'pipe' axis"):
        dec(torch.zeros(4, 6, 32), torch.zeros(4, 3, 32))


def test_pipelined_decoder_matches_jax(ranks):
    want_out, want_grads = ranks["dec"]
    want_flat = dict(zip(*_named(want_grads)))
    for r in range(WORLD):
        out = _result(ranks, "pipe_decoder", r)
        index, count = out["rows"]
        with np.load(os.path.join(ranks["dir"],
                                  f"pipe_decoder.r{r}.npz")) as z:
            rows = slice(index * 8 // count, (index + 1) * 8 // count)
            np.testing.assert_allclose(z["out"], want_out[rows], rtol=1e-5,
                                       atol=1e-5)
            grads, _ = to_flax({n: torch.from_numpy(z["grad/" + n])
                                for n in ranks["dec_names"]})
            for path, g in zip(*_named(grads)):
                np.testing.assert_allclose(g, want_flat[path], rtol=1e-4,
                                           atol=1e-4, err_msg=path)


def _named(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return ([jax.tree_util.keystr(p) for p, _ in leaves],
            [np.asarray(v) for _, v in leaves])
