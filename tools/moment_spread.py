"""The spread of a sharded bf16 train step against the one-process step, in
the port and in the JAX package, on the CPU.

    python tools/moment_spread.py [--out FILE]

One latent train step from the same seed-made weights (the port's, carried
to the JAX tree by ``convert.to_flax``) and the same batch, in bf16 at a
width both packages run on the CPU, every dropout 0:

- the port: the one-process step, then the step on data 2 and on model 2
  across two gloo processes (this script, started twice with ``--rank``);
- the JAX package: the one-device step, then the step sharded the same way
  over two of the host's virtual devices.

For each package and mesh it prints (and writes as JSON) what phase 18b
of ``chip_smoke.py`` measures on the card: the loss and grad norm
relative, and the first moments' largest error against the largest first
moment, with the three worst tensors.  A like spread in both packages
clears the port's collectives; a tighter JAX spread is the port's fault.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

VOCAB = 200
WIDTH = dict(emb_dim=64, hidden_dim=256, latent_dim=256, pwffn_dim=512,
             num_layers=2, num_heads=4, batch_size=16, image_size=64,
             max_q_length=20, dtype="bfloat16", attention_dropout=0.0,
             relu_dropout=0.0, layer_dropout=0.0, input_dropout=0.0,
             target_word_dropout=0.0)
MESHES = {"data 2": (2, 1), "model 2": (1, 2)}
SEED = 0


def _spread(mu, want_mu, loss, want_loss, gnorm, want_gnorm) -> dict:
    """The measures of chip_smoke.py's phase 18b: {name: numpy array}."""
    import numpy as np
    errs = sorted(((float(np.abs(mu[n].astype(np.float64)
                                 - want_mu[n].astype(np.float64)).max()),
                    float(np.abs(want_mu[n].astype(np.float64)).max()), n)
                   for n in want_mu), reverse=True)
    top = max(w for _, w, _ in errs)
    return {"loss_rel": abs(loss - want_loss) / abs(want_loss),
            "grad_norm_rel": abs(gnorm - want_gnorm) / abs(want_gnorm),
            "mu_rel": errs[0][0] / top,
            "worst_mu": [(n, e / top, e / (w or 1.0))
                         for e, w, n in errs[:3]]}


def _port_inputs():
    import numpy as np
    import torch
    from blt_vqg_tpu_torch.core.config import Config
    from blt_vqg_tpu_torch.models.iq import IQ
    from blt_vqg_tpu_torch.train.state import create_train_state
    from blt_vqg_tpu_torch.train.step import make_batch
    cfg = Config(**WIDTH)
    state = create_train_state(cfg, IQ(cfg, VOCAB), seed=SEED)
    batch = make_batch(cfg, VOCAB, cfg.batch_size,
                       np.random.RandomState(SEED + 1), device="cpu")
    eps = torch.randn((cfg.batch_size, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(SEED + 2))
    return cfg, state, batch, eps


def _port_mu(state) -> dict:
    """Whole first moments by parameter name, as numpy (f32)."""
    pl = state.placement
    opt = state.opt_state if pl is None else pl.full_opt(state.opt_state)
    return {n: v.float().numpy() for n, v in opt.mu.items()}


def port_rank(out: str) -> None:
    """One of the two gloo ranks: the one-process step on the whole batch,
    then the sharded steps on this rank's rows or heads."""
    import torch
    from blt_vqg_tpu_torch.core.distributed import initialize_distributed
    from blt_vqg_tpu_torch.parallel.mesh import build_mesh
    from blt_vqg_tpu_torch.parallel.sharding import place_state
    from blt_vqg_tpu_torch.train.step import make_train_step
    torch.set_num_threads(2)
    initialize_distributed(device="cpu", timeout_s=600)
    cfg, ref, batch, eps = _port_inputs()
    ref, ref_m = make_train_step(cfg, True)(ref, batch,
                                            torch.Generator(), eps=eps)
    want = _port_mu(ref)
    result = {}
    for tag, shape in MESHES.items():
        mesh = build_mesh(shape, ("data", "model"), device="cpu")
        _, state, _, _ = _port_inputs()
        state = place_state(state, mesh)
        index, count = mesh.batch_coord()
        n = cfg.batch_size // count
        rows = {k: v[index * n:(index + 1) * n] for k, v in batch.items()}
        state, m = make_train_step(cfg, True, mesh)(
            state, rows, torch.Generator(), eps=eps[index * n:(index + 1) * n])
        result[tag] = _spread(_port_mu(state), want, float(m["loss"]),
                              float(ref_m["loss"]), float(m["grad_norm"]),
                              float(ref_m["grad_norm"]))
    if torch.distributed.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(result, f)
    torch.distributed.destroy_process_group()


def run_port(tmp: str) -> dict:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = os.path.join(tmp, "port.json")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", out],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="2")) for r in range(2)]
    for p in procs:
        if p.wait(timeout=1800) != 0:
            raise RuntimeError(f"a port rank exited {p.returncode}")
    with open(out) as f:
        return json.load(f)


def run_jax() -> dict:
    """The JAX step on one device and sharded over two host devices."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=2").strip()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from blt_vqg_tpu.core.config import Config as JaxConfig
    from blt_vqg_tpu.models.iq import IQ as JaxIQ
    from blt_vqg_tpu.parallel.mesh import build_mesh
    from blt_vqg_tpu.parallel.sharding import (replicate, shard_batch,
                                               shard_params)
    from blt_vqg_tpu.train.schedule import noam_schedule
    from blt_vqg_tpu.train.state import TrainState, make_optimizer
    from blt_vqg_tpu.train.step import make_train_step
    from blt_vqg_tpu_torch.convert import to_flax
    jax.config.update("jax_default_matmul_precision", "highest")
    _, state, batch, _ = _port_inputs()
    params, stats = to_flax({k: v.clone() for k, v in
                             state.model.state_dict().items()})
    jcfg = JaxConfig(**WIDTH)
    np_batch = {k: v.numpy() for k, v in batch.items()}

    def fresh():
        p = jax.tree_util.tree_map(jnp.asarray, params)
        tx = make_optimizer(jcfg, p)
        return TrainState(
            step=jnp.zeros((), jnp.int32), kliter=jnp.zeros((), jnp.int32),
            params=p, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
            opt_state=tx.init(p), tx=tx, apply_fn=JaxIQ(jcfg, VOCAB).apply,
            lr_fn=noam_schedule(jcfg.hidden_dim, jcfg.warmup_steps))

    def flat_mu(s):
        leaves = jax.tree_util.tree_flatten_with_path(s.opt_state.mu)[0]
        return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
                for p, v in leaves}

    key = jax.random.key(SEED + 3)
    ref, ref_m = make_train_step(jcfg, True)(fresh(), np_batch, key)
    want = flat_mu(ref)
    result = {}
    for tag, shape in MESHES.items():
        mesh = build_mesh(shape, devices=jax.devices()[:2])
        s = fresh()
        s = s.replace(params=shard_params(s.params, mesh),
                      batch_stats=replicate(s.batch_stats, mesh),
                      opt_state=replicate(s.opt_state, mesh))
        s, m = make_train_step(jcfg, True, mesh)(
            s, shard_batch(np_batch, mesh), key)
        result[tag] = _spread(flat_mu(s), want, float(m["loss"]),
                              float(ref_m["loss"]), float(m["grad_norm"]),
                              float(ref_m["grad_norm"]))
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="JSON file to write")
    parser.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.rank is not None:
        port_rank(opts.rank)
        return
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        port = run_port(tmp)
    result = {"width": WIDTH, "port": port, "jax": run_jax()}
    for pkg in ("port", "jax"):
        for tag, r in result[pkg].items():
            print(f"{pkg} {tag}: loss {r['loss_rel']:.3g}, grad norm "
                  f"{r['grad_norm_rel']:.3g}, first moments {r['mu_rel']:.4g}"
                  f" of the largest (worst: {r['worst_mu']})")
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
