"""One rank of the port's point-to-point CPU checks (gloo): the ``seq`` ring
across processes and GPipe.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_p2p_worker.py OUT_DIR SCENARIO [SCENARIO ...]

Every scenario runs on a world of 4 ranks (``cuda_ring``: 2 ranks sharing
card 0 over gloo) and writes, per rank,
``OUT_DIR/<scenario>.r<rank>.json`` (its traceback if it raises, and the
rank stops); the shard and decoder scenarios also write arrays
(``OUT_DIR/<scenario>.r<rank>.npz``) that the test holds against the JAX
package.  Inputs the test wrote before the spawn are read from
``OUT_DIR/inputs.npz``.  Imports torch and the port only (never jax).
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch_parallel_worker as pw  # noqa: E402
from blt_vqg_tpu_torch.core.config import Config  # noqa: E402
from blt_vqg_tpu_torch.core.distributed import initialize_distributed  # noqa
from blt_vqg_tpu_torch.models.iq import IQ  # noqa: E402
from blt_vqg_tpu_torch.ops.kernels import ring_attention as tra  # noqa: E402
from blt_vqg_tpu_torch.parallel import collectives as col  # noqa: E402
from blt_vqg_tpu_torch.parallel.mesh import Mesh, build_mesh  # noqa: E402
from blt_vqg_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from blt_vqg_tpu_torch.parallel.sharding import place_state  # noqa: E402
from blt_vqg_tpu_torch.train.state import create_train_state  # noqa: E402

SEQ4 = ((4,), ("seq",))
SEQ2_DATA2 = ((2, 1, 2), ("data", "model", "seq"))
PIPE4 = ((4,), ("pipe",))
PIPE2_DATA2 = ((2, 2), ("data", "pipe"))
# the ring cases of tests/test_torch_ring_attention.py run here: n = 4 on
# seq 4, n = 2 on the seq rings of data 2 x seq 2
SHARD_CASES = {"n4_causal_pad": SEQ4, "n4_dead_row": SEQ4,
               "n2_causal_pad": SEQ2_DATA2}
# the train steps: the ring on (attention dropout 0: the gate), GPipe in
# deterministic mode (its dropout stream is not the sequential one)
SEQ_STEPS = {"seq4": SEQ4, "seq2_data2": SEQ2_DATA2,
             "seq2_model2": ((1, 2, 2), ("data", "model", "seq"))}
PIPE_CFG = dict(num_layers=2, pipeline_stages=2, pipeline_microbatches=2,
                attention_dropout=0.0, relu_dropout=0.0, layer_dropout=0.0,
                input_dropout=0.0, target_word_dropout=0.0)
# pipeline_apply: (stages, microbatches, mesh, batch split over data)
PIPE_CASES = {"s2_m2": (2, 2, PIPE2_DATA2, False),
              "s2_m4": (2, 4, PIPE2_DATA2, False),
              "s4_m4": (4, 4, PIPE4, False),
              "s2_m2_data2": (2, 2, PIPE2_DATA2, True)}
# JAX tests/test_pipeline.py's limits: forward, and its gradient test
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _rank() -> int:
    return torch.distributed.get_rank()


def _inputs(out_dir) -> dict:
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the transport

def scenario_protocol() -> dict:
    """The process ring's protocol on seq 4: seeding, hops both ways, the
    direct return into ``out``, ``join``, the differentiable ``permute``
    and its byte count."""
    mesh = build_mesh(*SEQ4, device="cpu")
    ring = mesh.ring("seq")
    r, n = ring.rank, ring.n
    out = {"kind": type(ring).__name__, "rank": r, "held": ring.held,
           "members": list(ring.members)}
    block = lambda src: torch.full((2, 3), float(src))
    got = []
    for direction in (+1, -1):
        ch = ring.channel([((2, 3), torch.float32), ((2,), torch.bool)],
                          direction)
        ch.seed(block(r)[None], torch.tensor([[r % 2 == 0, True]]))
        seen = []
        for step in range(n):
            x, flag = ch.slot(step)
            seen.append(int(x[0, 0, 0]))
            want_flag = (r - step * direction) % n % 2 == 0
            got.append(bool(flag[0, 0]) == want_flag)
            ch.release()
            if step < n - 1:
                ch.send(step)
        out[f"seen_{direction}"] = seen
        home = torch.empty(1, 2, 3)
        ch2 = ring.channel([((2, 3), torch.float32)], direction)
        ch2.seed(block(r)[None])
        ch2.send(0, hops=2, out=[home])
        ring.join()
        out[f"home_{direction}"] = int(home[0, 0, 0])
    out["flags_ok"] = all(got)
    before = ring.hop_bytes
    x = torch.full((3,), float(r), requires_grad=True)
    y = ring.permute(x, 1)
    w = torch.arange(3, dtype=torch.float32) + 10 * r
    (g,) = torch.autograd.grad((y * w).sum(), x)
    out["permute"] = y.tolist()
    out["permute_grad"] = g.tolist()
    out["permute_bytes"] = ring.hop_bytes - before
    return out


# ---------------------------------------------------------------------------
# the ring's shard functions on process ranks

def scenario_shards(out_dir, case) -> dict:
    """The four shard functions (plain versions) of this rank for one case
    of the inputs; its outputs go to the npz for the test."""
    z = _inputs(out_dir)
    mesh = build_mesh(*SHARD_CASES[case], device="cpu")
    ring = mesh.ring("seq")
    n, r = ring.n, ring.rank
    q, k, v, pad, do = (torch.from_numpy(z[f"{case}/{x}"])
                        for x in ("q", "k", "v", "pad", "do"))
    b, t = q.shape[:2]
    c = t // n

    def own(x):
        return x[:, r * c:(r + 1) * c][None].contiguous()

    q, k, v, pad, do = (own(x) for x in (q, k, v, pad, do))
    arrays, out = {}, {}
    for bidir in (False, True):
        tag = "bidir" if bidir else "one"
        fwd = (tra.ring_attention_fwd_bidir_shard if bidir
               else tra.ring_attention_fwd_shard)
        bwd = (tra.ring_attention_bwd_bidir_shard if bidir
               else tra.ring_attention_bwd_shard)
        o, m, l = fwd(q, k, v, pad, ring=ring, causal=True, return_lse=True)
        dq, dk, dv = bwd(q, k, v, pad, o, m, l, do, ring=ring, causal=True)
        for name, x in (("o", o), ("m", m), ("l", l), ("dq", dq),
                        ("dk", dk), ("dv", dv)):
            arrays[f"{tag}/{name}"] = x[0].numpy()
    # the same live blocks: the same running max; the denominators sum
    # them in the two schedules' orders
    out["residuals_agree"] = [
        bool(np.array_equal(arrays["one/m"], arrays["bidir/m"])),
        bool(np.allclose(arrays["one/l"], arrays["bidir/l"], rtol=1e-6,
                         atol=0))]
    out["launches"] = [f.launches for f in (
        tra.ring_attention_fwd_shard, tra.ring_attention_bwd_shard)]
    out["plan"] = [len(e) for e in tra.ring_plan(n, True, True, r)]
    np.savez(os.path.join(out_dir, f"shards_{case}.r{_rank()}.npz"),
             **arrays)
    return out


# ---------------------------------------------------------------------------
# the train steps

def _state(cfg, mesh):
    state = create_train_state(cfg, IQ(cfg, pw.VOCAB, mesh), seed=0)
    state.tx.eps = pw.ADAM_EPS
    with torch.no_grad():
        state.model.encoder_cnn.feat_bn.weight.mul_(pw.FEAT_BN_SCALE)
    return state


def _step_scenario(cfg, mesh, local_mesh, ref_cfg=None) -> dict:
    """Pretrain step, Adam reset, latent step and a latent eval step on
    ``mesh`` against one process on ``local_mesh`` (the whole batch; with
    ``ref_cfg`` in place of ``cfg``)."""
    batches = pw._batches(cfg, 3)
    ref_cfg = ref_cfg or cfg
    ref, ref_m, ref_ev = pw._run(ref_cfg, _state(ref_cfg, local_mesh),
                                 batches, None, "phases")
    state = place_state(_state(cfg, mesh), mesh)
    state, got_m, got_ev = pw._run(
        cfg, state, [pw._rows(b, mesh) for b in batches], mesh, "phases")
    out = pw.compare(ref, ref_m, ref_ev, state, got_m, got_ev)
    return out


def scenario_seq_step(name) -> dict:
    shape, names = SEQ_STEPS[name]
    cfg = Config(**pw.TINY).replace(sequence_parallel=True,
                                    ring_attention_impl="pallas",
                                    attention_dropout=0.0)
    mesh = build_mesh(shape, names, device="cpu")
    n = mesh.shape["seq"]
    out = _step_scenario(cfg, mesh, Mesh({"seq": n}, "cpu"))
    ring = mesh.ring("seq")
    out["ring"] = [type(ring).__name__, ring.n, ring.hop_bytes > 0]
    return out


def scenario_pipe_step() -> dict:
    """pipe 2 x data 2, two microbatches, against the one-process step."""
    cfg = Config(**pw.TINY).replace(**PIPE_CFG)
    mesh = build_mesh(*PIPE2_DATA2, device="cpu")
    return _step_scenario(cfg, mesh, None, cfg.replace(pipeline_stages=1))


# ---------------------------------------------------------------------------
# pipeline_apply

def _stack(n_layers, d, seed):
    r = np.random.RandomState(seed)
    w = torch.tensor(r.randn(n_layers, d, d).astype(np.float32) * 0.3,
                     requires_grad=True)
    b = torch.tensor(r.randn(n_layers, d).astype(np.float32) * 0.1,
                     requires_grad=True)
    return w, b


def _err(got, want, rtol, atol) -> float:
    return pw._err(got, want, rtol, atol)


def scenario_pipe_apply() -> dict:
    """Forward and gradients of ``pipeline_apply`` against the sequential
    stack (a batch-aligned side input riding the schedule), per case; the
    gradients of the stacked weights summed over ``pipe`` (and ``data``
    where the batch is split), as the train step sums them."""
    out = {}
    n_layers, d, batch = 8, 8, 8
    for case, (stages, m, mesh_def, split) in PIPE_CASES.items():
        mesh = build_mesh(*mesh_def, device="cpu")
        assert mesh.shape["pipe"] == stages
        w, b = _stack(n_layers, d, seed=stages * 10 + m)
        r = np.random.RandomState(m)
        x = torch.tensor(r.randn(batch, 2, d).astype(np.float32))
        side = torch.tensor(r.randn(batch, 2, d).astype(np.float32),
                            requires_grad=True)

        def layer(i, xm, bargs, gen):
            return torch.tanh(xm @ w[i] + b[i]) + bargs[0]

        want = x
        for i in range(n_layers):
            want = layer(i, want, (side,), None)
        gw, gb, gs = torch.autograd.grad((want ** 2).sum(), (w, b, side))
        rows = pw._rows({"x": x}, mesh)["x"] if split else x
        srows = pw._rows({"s": side}, mesh)["s"] if split else side
        got = pipeline_apply(layer, [(w, b)] * n_layers, rows, mesh,
                             microbatches=m, batch_args=(srows,))
        pg = torch.autograd.grad((got ** 2).sum(), (w, b, side))
        pg = [col.all_reduce(g, mesh.group("pipe")) for g in pg[:2]] + [
            pg[2]]
        if split:
            pg = [col.all_reduce(g, mesh.group("data")) for g in pg]
        index, count = mesh.batch_coord() if split else (0, 1)
        sl = slice(index * batch // count, (index + 1) * batch // count)
        out[case] = {"fwd": _err(got, want[sl], **FWD_TOL),
                     "grad_w": _err(pg[0], gw, **GRAD_TOL),
                     "grad_b": _err(pg[1], gb, **GRAD_TOL),
                     "grad_side": _err(pg[2], gs, **GRAD_TOL)}
    return out


def scenario_pipe_dropout() -> dict:
    """Noise drawn per (layer, microbatch) generator: the outputs of 1, 2
    and 4 stages are bit-equal."""
    n_layers, d = 4, 8
    r = np.random.RandomState(6)
    w = torch.tensor(r.randn(n_layers, d, d).astype(np.float32) * 0.2)
    x = torch.ones((8, 2, d))

    def noisy(i, xm, bargs, gen):
        return xm @ w[i] + torch.randn(xm.shape, generator=gen) * 0.01

    outs = {}
    for stages, mesh in ((1, Mesh({"pipe": 1}, "cpu")),
                         (2, build_mesh(*PIPE2_DATA2, device="cpu")),
                         (4, build_mesh(*PIPE4, device="cpu"))):
        outs[stages] = pipeline_apply(
            noisy, [(w,)] * n_layers, x, mesh, microbatches=2,
            generator=torch.Generator().manual_seed(9))
    seq = x
    for i in range(n_layers):
        seq = noisy(i, seq, (), torch.Generator().manual_seed(i))
    return {"equal_1_2": bool(torch.equal(outs[1], outs[2])),
            "equal_1_4": bool(torch.equal(outs[1], outs[4])),
            "differs_from_other_draws": not bool(torch.equal(outs[1], seq))}


def scenario_pipe_decoder(out_dir) -> dict:
    """The pipelined ``TransformerDecoder`` (deterministic) from the test's
    weights: its output on data 2 x pipe 2 (this rank's rows), and the
    gradients of sum(out^2) over the whole batch on pipe 2 (the layers'
    summed over ``pipe``)."""
    from blt_vqg_tpu_torch.ops.transformer import TransformerDecoder
    z = _inputs(out_dir)
    kw = dict(hidden_dim=32, num_layers=4, num_heads=4, pwffn_dim=64,
              attention_dropout=0.0, relu_dropout=0.0, dtype=torch.float32,
              max_decode_len=8)
    mesh = build_mesh(*PIPE2_DATA2, device="cpu")
    dec = TransformerDecoder(**kw, pipeline_stages=2,
                             pipeline_microbatches=2, pipeline_mesh=mesh)
    dec.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in z.items()
                         if k.startswith("dec/")})
    x, enc = (torch.from_numpy(z[f"decin/{k}"]) for k in ("x", "enc"))
    src = torch.from_numpy(z["decin/src_mask"])
    rows = pw._rows({"x": x, "enc": enc, "src": src}, mesh)
    out = dec(rows["x"], rows["enc"], rows["src"], None)
    names = [n for n, _ in dec.named_parameters()]
    params = list(dec.parameters())
    grads = torch.autograd.grad((dec(x, enc, None, None) ** 2).sum(),
                                params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    grads = [col.all_reduce(g, mesh.group("pipe")) if n.startswith("layer_")
             else g for g, n in zip(grads, names)]
    np.savez(os.path.join(out_dir, f"pipe_decoder.r{_rank()}.npz"),
             out=out.detach().numpy(),
             **{"grad/" + n: g.numpy() for n, g in zip(names, grads)})
    return {"rows": list(mesh.batch_coord())}


# the card case of tests/test_torch_kernels_cuda.py: (batch, chunk, heads,
# head dim, pads) on a ring of 2 processes, causal
CUDA_RING_CASES = ((3, 10, 2, 128, "tail"), (2, 65, 2, 80, "dead"))


def scenario_cuda_ring(out_dir) -> dict:
    """Rows 6a-6d on card 0 on this rank of a ring of 2 processes: the
    kernels and their plain versions on the same shards (f32 and bf16,
    one-way and two-way), written to the npz; the launches of each call."""
    mesh = build_mesh((2,), ("seq",), device="cuda")
    ring = mesh.ring("seq")
    r = ring.rank
    arrays, launches = {}, {}
    for i, (b, c, h, d, pad) in enumerate(CUDA_RING_CASES):
        g = np.random.RandomState(51 + i)
        t = 2 * c
        x = [torch.from_numpy(g.randn(b, t, h, d).astype(np.float32))
             for _ in range(4)]
        x[0] = x[0] * d ** -0.5
        kv_pad = np.arange(t)[None, :] >= g.randint(1, t + 1, b)[:, None]
        if pad == "dead":
            kv_pad[:, 0] = True
            kv_pad[1] = True
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (y[:, r * c:(r + 1) * c][None].to(dt).cuda()
                           .contiguous() for y in x)
            kp = torch.from_numpy(kv_pad[:, r * c:(r + 1) * c][None].copy()
                                  ).cuda()
            for bidir in (False, True):
                tag = f"case{i}/{str(dt)[6:]}/{'two' if bidir else 'one'}"
                fwd = (tra.ring_attention_fwd_bidir_shard if bidir
                       else tra.ring_attention_fwd_shard)
                bwd = (tra.ring_attention_bwd_bidir_shard if bidir
                       else tra.ring_attention_bwd_shard)
                before = (fwd.launches, bwd.launches)
                o, m, l = fwd(q, k, v, kp, ring=ring, causal=True,
                              return_lse=True)
                grads = bwd(q, k, v, kp, o, m, l, do, ring=ring, causal=True)
                torch.cuda.synchronize()
                launches[tag] = [fwd.launches - before[0],
                                 bwd.launches - before[1]]
                want = getattr(tra, fwd.__name__ + "_ref")(
                    q, k, v, kp, ring=ring, causal=True)
                want_g = getattr(tra, bwd.__name__ + "_ref")(
                    q, k, v, kp, o, m, l, do, ring=ring, causal=True)
                for name, got_x, want_x in zip(
                        ("o", "m", "l", "dq", "dk", "dv"), (o, m, l, *grads),
                        (*want, *want_g)):
                    arrays[f"{tag}/{name}/got"] = got_x.float().cpu().numpy()
                    arrays[f"{tag}/{name}/want"] = (want_x.float().cpu()
                                                    .numpy())
    np.savez(os.path.join(out_dir, f"cuda_ring.r{_rank()}.npz"), **arrays)
    live = sum(1 for e in tra.ring_plan(2, True, True, r) if e)
    live_one = sum(1 for e in tra.ring_plan(2, True, False, r) if e)
    return {"launches": launches, "live": [live_one, live]}


def main():
    out_dir, names = sys.argv[1], sys.argv[2:]
    torch.set_num_threads(1)
    on_card = all(n.startswith("cuda_") for n in names)
    initialize_distributed(device="cuda" if on_card else "cpu",
                           backend="gloo", local_rank=0, timeout_s=90)
    for name in names:
        path = os.path.join(out_dir, f"{name}.r{_rank()}.json")
        try:
            if name == "protocol":
                result = scenario_protocol()
            elif name.startswith("shards_"):
                result = scenario_shards(out_dir, name[len("shards_"):])
            elif name in SEQ_STEPS:
                result = scenario_seq_step(name)
            elif name == "pipe_step":
                result = scenario_pipe_step()
            elif name == "pipe_apply":
                result = scenario_pipe_apply()
            elif name == "pipe_dropout":
                result = scenario_pipe_dropout()
            elif name == "pipe_decoder":
                result = scenario_pipe_decoder(out_dir)
            elif name == "cuda_ring":
                result = scenario_cuda_ring(out_dir)
            else:
                raise ValueError(f"unknown scenario {name!r}")
        except BaseException:
            with open(path, "w") as f:
                json.dump({"error": traceback.format_exc()}, f)
            raise
        with open(path, "w") as f:
            json.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
