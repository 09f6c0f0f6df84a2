"""One rank of the port's multi-process CPU checks (gloo).

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_parallel_worker.py OUT_DIR SCENARIO [SCENARIO ...]

Each scenario builds the tiny model from a seed on every rank, runs the
single-process step on the whole global batch (no collectives), then the
same steps sharded over a mesh of the world on this rank's rows, and
writes, per rank, the largest errors of the sharded run against the
single-process one (metrics, batch-norm statistics, this rank's blocks of
the parameters and of the optimizer state) to ``OUT_DIR/<scenario>.r<rank>
.json``.  A scenario that raises writes its traceback instead, and the rank
stops.  Imports torch and the port only (never jax).
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from blt_vqg_tpu_torch.core.config import Config  # noqa: E402
from blt_vqg_tpu_torch.core.distributed import initialize_distributed  # noqa
from blt_vqg_tpu_torch.models.iq import IQ  # noqa: E402
from blt_vqg_tpu_torch.parallel import collectives as col  # noqa: E402
from blt_vqg_tpu_torch.parallel.mesh import (build_hybrid_mesh,  # noqa: E402
                                             build_mesh)
from blt_vqg_tpu_torch.parallel.sharding import place_state  # noqa: E402
from blt_vqg_tpu_torch.train.fused_adam import FactoredNu  # noqa: E402
from blt_vqg_tpu_torch.train.state import create_train_state  # noqa: E402
from blt_vqg_tpu_torch.train.step import (make_batch,  # noqa: E402
                                          make_eval_step, make_multi_step,
                                          make_train_step)

VOCAB = 32
# the tests/test_multiprocess.py configuration, dropout on
TINY = dict(emb_dim=8, hidden_dim=16, latent_dim=12, pwffn_dim=32,
            num_layers=1, num_heads=2, batch_size=8, image_size=24,
            max_q_length=8, dtype="float32", attention_dropout=0.1,
            relu_dropout=0.1, layer_dropout=0.1, input_dropout=0.1,
            target_word_dropout=0.2, full_kl_step=6, kl_floor=0.2,
            warmup_steps=4, lr=1.0)
DP_TP = ((2, 2), ("data", "model"))
DP4 = ((4, 1), ("data", "model"))
# name: (mesh, config overrides, placement, steps)
SCENARIOS = {
    "dp4": (DP4, {}, {}, "phases"),
    "dp2_tp2": (DP_TP, {}, {}, "phases"),
    "zero1_fused": (DP4, {}, {"zero": True}, "phases"),
    "zero1_chain": (DP4, {"fused_adam": False}, {"zero": True}, "phases"),
    "zero1_factored": (DP_TP, {"adam_factored_nu": True}, {"zero": True},
                       "phases"),
    "fsdp": (DP_TP, {}, {"fsdp": True}, "phases"),
    "ep": (((2, 1, 2), ("data", "model", "expert")),
           {"moe_num_experts": 4, "moe_router_noise": 0.5}, {}, "phases"),
    "hybrid": ("hybrid", {}, {}, "phases"),
    "multi_step": (DP_TP, {}, {}, "multi"),
}
TOL = dict(rtol=2e-4, atol=1e-5)
# Adam's eps on both sides: at 1e-8 an element whose gradient is rounding
# noise (0 in exact arithmetic, as the fc bias in front of the train-mode
# batch norm) moves by +-lr in either run, whatever the summation order
ADAM_EPS = 1e-3
# feat_bn's scale on both sides, as tests/test_torch_train.py sets it: the
# train-mode batch norm over 8 images is ill-conditioned in f32, and its
# scale carries that rounding into the fc gradient (Adam then divides it
# by eps)
FEAT_BN_SCALE = 0.01
BN_TOL = dict(rtol=2e-4, atol=1e-6)


def _err(got, want, rtol, atol) -> float:
    """max(|got - want| - rtol * |want|) / atol: <= 1 within the limits."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.numel() == 0:
        return 0.0
    return float(((got - want).abs() - rtol * want.abs()).max() / atol)


def _batches(cfg, n):
    r = np.random.RandomState(5)
    return [make_batch(cfg, VOCAB, cfg.batch_size, r, device="cpu")
            for _ in range(n)]


def _gen(i):
    return torch.Generator().manual_seed(1000 + i)


def _run(cfg, state, batches, mesh, kind):
    """pretrain step, Adam reset, latent step (``kind`` "phases"), or a
    G = 2 multi step in the latent phase ("multi"); returns the last
    metrics and the latent eval metrics."""
    if kind == "multi":
        state.reset_optimizer()
        if mesh is None:
            step = make_train_step(cfg, latent_mode=True)
            for i, b in enumerate(batches[:2]):
                state, metrics = step(state, b, _gen(i))
        else:
            stacked = {k: torch.stack([b[k] for b in batches[:2]])
                       for k in batches[0]}
            state, metrics = make_multi_step(cfg, True, mesh)(
                state, stacked, _gen)
    else:
        state, _ = make_train_step(cfg, False, mesh)(state, batches[0],
                                                    _gen(0))
        state.reset_optimizer()
        state, metrics = make_train_step(cfg, True, mesh)(state, batches[1],
                                                         _gen(1))
    ev = make_eval_step(cfg, True, mesh)(state, batches[2], _gen(7))
    return state, metrics, ev


def _rows(batch, mesh):
    index, count = mesh.batch_coord()
    n = next(iter(batch.values())).shape[0] // count
    return {k: v[index * n:(index + 1) * n] for k, v in batch.items()}


def new_state(cfg):
    state = create_train_state(cfg, IQ(cfg, VOCAB), seed=0)
    state.tx.eps = ADAM_EPS
    with torch.no_grad():
        state.model.encoder_cnn.feat_bn.weight.mul_(FEAT_BN_SCALE)
    return state


def scenario(name, batches=None):
    mesh_def, over, place, kind = SCENARIOS[name]
    cfg = Config(**TINY).replace(**over)
    mesh = (build_hybrid_mesh(2, 1, 2, device="cpu") if mesh_def == "hybrid"
            else build_mesh(*mesh_def, device="cpu"))
    batches = batches or _batches(cfg, 3)
    ref, ref_m, ref_ev = _run(cfg, new_state(cfg), batches, None, kind)
    state = place_state(new_state(cfg), mesh, **place)
    state, got_m, got_ev = _run(cfg, state, [_rows(b, mesh) for b in batches],
                                mesh, kind)
    return compare(ref, ref_m, ref_ev, state, got_m, got_ev)


def compare(ref, ref_m, ref_ev, state, got_m, got_ev) -> dict:
    pl = state.placement
    out = {"metrics": {}, "eval": {}, "params": 0.0, "bn": 0.0, "opt": 0.0,
           "step": [state.step, state.kliter, state.opt_state.count],
           "ref_step": [ref.step, ref.kliter, ref.opt_state.count]}
    for k, v in ref_m.items():
        out["metrics"][k] = _err(got_m[k], v, **TOL)
    for k, v in ref_ev.items():
        out["eval"][k] = _err(got_ev[k], v, **TOL)
    want_p = dict(ref.model.named_parameters())
    for n, p in state.model.named_parameters():
        w = pl.local(want_p[n].data, pl.store[n])
        out["params"] = max(out["params"], _err(p.data, w, **TOL))
    want_b = dict(ref.model.named_buffers())
    for n, b in state.model.named_buffers():
        out["bn"] = max(out["bn"], _err(b, want_b[n], **BN_TOL))
    want_o = pl.place_opt(ref.opt_state)
    for field in ("mu", "nu", "master"):
        got_f, want_f = getattr(state.opt_state, field), getattr(want_o, field)
        assert set(got_f) == set(want_f), field
        for n, v in got_f.items():
            pairs = (zip(v, want_f[n]) if isinstance(v, FactoredNu)
                     else [(v, want_f[n])])
            for g, w in pairs:
                # moments of a gradient that is zero in exact arithmetic
                # are rounding noise: an absolute floor of 1e-10
                out["opt"] = max(out["opt"], _err(g, w, rtol=2e-4,
                                                  atol=1e-5 if field
                                                  != "nu" else 1e-10))
    return out


def scenario_pads():
    """DP 4 on targets whose pad counts differ between the shards (rank r's
    rows keep 8 - 2r tokens), and the control: the mean of the ranks' own
    token means, which is not the global token mean here."""
    cfg = Config(**TINY)
    batches = _batches(cfg, 3)
    keep = torch.tensor([8, 8, 6, 6, 4, 4, 2, 2])
    for b in batches:
        b["target"][torch.arange(8)[None, :] >= keep[:, None]] = 0
    out = scenario("dp4", batches)
    mesh = build_mesh(*DP4, device="cpu")
    state = new_state(cfg)
    # one process's eval step on this rank's rows alone: its own mean
    own = make_eval_step(cfg, True)(state, _rows(batches[2], mesh), _gen(7))
    ref = make_eval_step(cfg, True)(state, batches[2], _gen(7))
    mean_of_means = col.all_reduce(own["rec"], mesh.group("data")) / 4
    out["mean_of_means_err"] = _err(mean_of_means, ref["rec"], **TOL)
    return out


def scenario_jax(out_dir):
    """The data 2 x model 2 latent step from the weights, batch and
    posterior noise that the test wrote (``jax_in.npz``, every dropout 0);
    rank 0 writes the whole state after it (``jax_out.npz``)."""
    z = np.load(os.path.join(out_dir, "jax_in.npz"))
    cfg = Config(**TINY).replace(attention_dropout=0.0, relu_dropout=0.0,
                                 layer_dropout=0.0, input_dropout=0.0,
                                 target_word_dropout=0.0)
    model = IQ(cfg, VOCAB)
    model.load_state_dict({k[3:]: torch.from_numpy(z[k]) for k in z.files
                           if k.startswith("sd/")})
    state = create_train_state(cfg, model, seed=None)
    mesh = build_mesh(*DP_TP, device="cpu")
    state = place_state(state, mesh)
    batch = _rows({k[6:]: torch.from_numpy(z[k]) for k in z.files
                   if k.startswith("batch/")}, mesh)
    eps = _rows({"eps": torch.from_numpy(z["eps"])}, mesh)["eps"]
    state, metrics = make_train_step(cfg, True, mesh)(state, batch, _gen(0),
                                                      eps=eps)
    pl = state.placement
    sd = pl.full_state_dict(state.model)
    opt = pl.full_opt(state.opt_state)
    if int(os.environ["RANK"]) == 0:
        flat = {"sd/" + k: v.numpy() for k, v in sd.items()}
        flat.update({f"{f}/{k}": v.numpy() for f in ("mu", "nu")
                     for k, v in getattr(opt, f).items()})
        flat.update({"metrics/" + k: v.numpy() for k, v in metrics.items()})
        flat["counts"] = np.array([state.step, state.kliter, opt.count])
        np.savez(os.path.join(out_dir, "jax_out.npz"), **flat)
    return {"done": True}


def scenario_multihost(out_dir):
    """On data 2 x model 2: this rank's loader rows; a ZeRO-1 state after
    one step, written sharded (``port_sharded``) and whole (``port_plain``)
    and read back; and the JAX package's shard files (``jax_sharded``)
    restored and written whole (``port_from_jax``)."""
    from blt_vqg_tpu_torch.core.checkpoint import CheckpointManager
    from blt_vqg_tpu_torch.data.loader import make_loader
    from blt_vqg_tpu_torch.data.packed import PackedDataset
    from blt_vqg_tpu_torch.text.vocabulary import load_vocab
    rank = int(os.environ["RANK"])
    mesh = build_mesh(*DP_TP, device="cpu")
    vocab = load_vocab(os.path.join(out_dir, "vocab.json"))
    ds = PackedDataset(os.path.join(out_dir, "packed"), vocab)
    rows = list(make_loader(ds, 8, "ans", shuffle=True, seed=3, epochs=1,
                            mesh=mesh, device=False))
    np.savez(os.path.join(out_dir, f"rows_r{rank}.npz"),
             image_ids=np.stack([b["image_ids"] for b in rows]),
             target=np.stack([b["target"] for b in rows]))

    cfg = Config(**TINY)
    state = place_state(new_state(cfg), mesh, zero=True)
    batch = _rows(_batches(cfg, 1)[0], mesh)
    state, _ = make_train_step(cfg, False, mesh)(state, batch, _gen(0))
    CheckpointManager(os.path.join(out_dir, "port_sharded")).save_sharded(
        state, cfg)
    CheckpointManager(os.path.join(out_dir, "port_plain")).save(state, cfg)
    back = place_state(new_state(cfg), mesh, zero=True)
    CheckpointManager(os.path.join(out_dir, "port_sharded")).restore_sharded(
        back)
    same = _bit_equal(state, back)
    mine = place_state(new_state(cfg), mesh, zero=True)
    # the test writes the JAX package's files while the ranks run
    ready = os.path.join(out_dir, "jax_sharded.ready")
    for _ in range(1200):
        if os.path.exists(ready):
            break
        time.sleep(0.1)
    CheckpointManager(os.path.join(out_dir, "jax_sharded")).restore_sharded(
        mine)
    CheckpointManager(os.path.join(out_dir, "port_from_jax")).save(mine, cfg)
    # shard_params cuts whole parameters as the placement does
    from blt_vqg_tpu_torch.core.distributed import host_local_batch_to_global
    from blt_vqg_tpu_torch.parallel.sharding import shard_params
    whole = {n: p.detach() for n, p in new_state(cfg).model
             .named_parameters()}
    cut = shard_params(whole, mesh)
    tp = place_state(new_state(cfg), mesh)
    same_cut = all(torch.equal(cut[n], p) for n, p in
                   tp.model.named_parameters())
    local = host_local_batch_to_global(batch, mesh)
    return {"round_trip_bit_equal": same, "step": mine.step,
            "shard_params_equal": same_cut,
            "local_batch": [local.start, local.global_size],
            "fit": _fit_fsdp(out_dir, ds, vocab, mesh)}


def _fit_fsdp(out_dir, ds, vocab, mesh) -> dict:
    """``Trainer.fit`` under FSDP on the mesh: 2 steps and a validation
    whose report rank 0 decodes with the gathered weights."""
    from blt_vqg_tpu_torch.data.loader import make_loader
    from blt_vqg_tpu_torch.train.trainer import Trainer
    sys.modules["torch.utils.tensorboard"] = None   # TensorFlow's import
    cfg = Config(**TINY).replace(
        fsdp=True, num_pretraining_steps=1, total_training_steps=2,
        val_check_interval=2, limit_val_batches=1, checkpoint_every=2,
        max_decode_length=4, latent_diagnostics=True,
        output_dir=os.path.join(out_dir, "fit"))
    trainer = Trainer(cfg, vocab, mesh=mesh, device="cpu")
    train = make_loader(ds, 8, "ans", seed=0, mesh=mesh, device="cpu")
    state = trainer.init_state(next(train), resume=False)
    state = trainer.fit(state, train, lambda: make_loader(
        ds, 8, "ans", shuffle=False, epochs=1, mesh=mesh, device="cpu"))
    train.close()
    val = trainer.validate(state, make_loader(
        ds, 8, "ans", shuffle=False, epochs=1, mesh=mesh, device="cpu"),
        True, state.step, print_samples=0)
    return {"step": state.step, "val": {k: float(v) for k, v in val.items()},
            "split_report_model": trainer.report_model is not trainer.model}


def _bit_equal(a, b) -> bool:
    if (a.step, a.kliter, a.opt_state.count) != (b.step, b.kliter,
                                                 b.opt_state.count):
        return False
    sa, sb = a.model.state_dict(), b.model.state_dict()
    pairs = [(sa[k], sb[k]) for k in sa]
    for f in ("mu", "nu", "master"):
        fa, fb = getattr(a.opt_state, f), getattr(b.opt_state, f)
        if set(fa) != set(fb):
            return False
        pairs += [(fa[k], fb[k]) for k in fa]
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
               for x, y in pairs)


def main():
    out_dir, names = sys.argv[1], sys.argv[2:]
    torch.set_num_threads(1)
    initialize_distributed(device="cpu", timeout_s=90)
    rank = int(os.environ["RANK"])
    for name in names:
        path = os.path.join(out_dir, f"{name}.r{rank}.json")
        try:
            if name == "jax":
                result = scenario_jax(out_dir)
            elif name == "multihost":
                result = scenario_multihost(out_dir)
            elif name == "pads":
                result = scenario_pads()
            else:
                result = scenario(name)
        except BaseException:
            with open(path, "w") as f:
                json.dump({"error": traceback.format_exc()}, f)
            raise
        with open(path, "w") as f:
            json.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()


def start(out_dir, names, world=4, args=None):
    """Starts ``world`` ranks of this script (or of ``args``, a command
    after the interpreter) on a free local port; returns the processes."""
    import socket
    import subprocess
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = args if args is not None else [os.path.abspath(__file__), out_dir,
                                         *names]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, *cmd], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    return procs


def join(procs, timeout: float) -> list:
    """Waits for every rank (killing them all past ``timeout`` seconds);
    returns (exit code, output) per rank."""
    import subprocess
    import time
    end = time.time() + timeout
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(1.0, end - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text.decode(errors="replace")))
    return out
