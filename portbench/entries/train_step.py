"""The latent-phase train step, ``make_train_step(cfg, latent_mode=True)``.

Set-up builds one train state (the program's model with the benchmark's
weights, ``create_train_state``, the global step at the configuration's
first latent step), drives it through its first ``check_steps`` steps with
the window's own call and feed, and hands the same object to the window,
which cycles a pool of batches made on the device from the seed (images,
category contexts, posteriors and targets of 8-20 words, and the
posterior noise, handed to the step as ``eps``).

The check: the reference repeats the first steps from the same weights,
batches and noise, and three numbers are compared, each the worst case:
the loss of each step; the norm of each leaf's first gradient as the
optimizer took it (the program's first moment after one step over
1 - b1); the norm of each leaf's change over the first steps, leaving out
leaves whose reference gradient is under a thousandth of the median
leaf's.  A leaf is held against the larger of its reference norm and the
median leaf's.
"""

from __future__ import annotations

import gc
import itertools
import time

import torch

from portbench.harness import program
from portbench.harness.cells import sub_seed
from portbench.harness.weights import make_weights
from portbench.reference import full_precision
from portbench.reference.iq import RefIQ
from portbench.reference.train import (RefTrainer, leaf_norms, trainable,
                                       worst_leaf_gap)

B1 = 0.9


def make_pool(traffic: dict, model: dict, vocab: int, seed: int, device):
    """``pool_batches`` batches of the batch contract, stacked [K, B, ...],
    and the posterior noise [K, B, latent]."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, "pool"))
    k, b, s = traffic["pool_batches"], traffic["batch"], model["image_size"]
    lo, hi = traffic["min_words"], traffic["max_words"]

    def padded(t):
        tok = torch.randint(1, vocab, (k, b, t), generator=g, device=device)
        n = torch.randint(min(lo, t), min(hi, t) + 1, (k, b, 1), generator=g,
                          device=device)
        pos = torch.arange(t, device=device)
        return torch.where(pos >= n, torch.zeros_like(tok), tok).to(
            torch.int32)

    cats = torch.randint(0, traffic["categories"], (k, b), generator=g,
                         device=device)
    pool = {"images": torch.rand((k, b, s, s, 3), generator=g, device=device),
            "context": torch.stack([torch.ones_like(cats), 6 + cats,
                                    torch.full_like(cats, 3)], -1).to(
                                        torch.int32),
            "posterior": padded(model["max_q_length"] + 1),
            "target": padded(model["max_q_length"])}
    eps = torch.randn((k, b, model["latent_dim"]), generator=g, device=device)
    return pool, eps


def batch_of(pool: dict, i: int) -> dict:
    k = next(iter(pool.values())).shape[0]
    return {key: v[i % k] for key, v in pool.items()}


def opt_settings(model: dict) -> dict:
    keys = ("kl_ceiling", "full_kl_step", "aux_ceiling", "image_recon_lambda",
            "grad_clip", "hidden_dim", "warmup_steps")
    return {key: model[key] for key in keys}


class Trainer:
    """The program's train state and step for one run."""

    def __init__(self, ctx):
        from blt_vqg_tpu_torch.train import state as states
        from blt_vqg_tpu_torch.train import step as steps
        cell, dev = ctx.cell, ctx.device
        self.m, self.vocab = cell.model, cell.config["vocab_size"]
        cfg = program.port_config(cell.model, {**cell.traffic["overrides"],
                                               **ctx.overrides})
        program.load_library(dev)
        ctx.mark("library")
        net = program.build_model(cfg, self.vocab, cell.model, ctx.seed, dev,
                                  cast=False)
        self.state = states.create_train_state(cfg, net, seed=None)
        self.state.step = cfg.num_pretraining_steps    # the latent phase
        self.step_fn = steps.make_train_step(cfg, latent_mode=True)
        ctx.mark("weights")
        self.gen = torch.Generator(dev).manual_seed(sub_seed(ctx.seed, "drop"))
        self.pool, self.eps = make_pool(cell.traffic, cell.model, self.vocab,
                                        ctx.seed, dev)
        ctx.mark("pool")
        self.k = cell.traffic["pool_batches"]

    def step(self, i: int):
        self.state, metrics = self.step_fn(self.state, batch_of(self.pool, i),
                                           self.gen, self.eps[i % self.k])
        return metrics

    def first_steps(self, n: int, seed: int, device) -> dict:
        """Steps 0..n-1 with the readings the check compares."""
        losses, g1 = [], None
        for i in range(n):
            losses.append(float(self.step(i)["loss"]))
            if i == 0:
                g1 = {name: float(torch.linalg.vector_norm(mu.float()))
                      / (1 - B1)
                      for name, mu in self.state.opt_state.mu.items()}
        w0 = make_weights(self.m, self.vocab, seed, device)
        delta = {name: float(torch.linalg.vector_norm(p.detach().float()
                                                      - w0[name]))
                 for name, p in self.state.trainable().items()}
        return {"losses": losses, "g1": g1, "delta": delta}


def reference_readings(ctx, operand=None, gradient=None) -> dict:
    """The reference's first steps (``operand`` and ``gradient``: the
    lower-precision control in the program's place)."""
    tr, m = ctx.cell.traffic, ctx.cell.model
    vocab, dev = ctx.cell.config["vocab_size"], ctx.device
    full_precision()
    pool, eps = make_pool(tr, m, vocab, ctx.seed, dev)
    ref = RefIQ(make_weights(m, vocab, ctx.seed, dev), m, operand=operand,
                gradient=gradient)
    p0 = {n: v.clone() for n, v in ref.p.items() if trainable(n)}
    trainer = RefTrainer(ref, opt_settings(m), step=m["num_pretraining_steps"])
    losses, g1 = [], None
    for i in range(tr["check_steps"]):
        out = trainer.step_once(batch_of(pool, i), eps[i])
        losses.append(out["loss"])
        if i == 0:
            g1 = leaf_norms(out["grads"])
    with torch.no_grad():
        delta = {n: float(torch.linalg.vector_norm(ref.p[n] - p0[n]))
                 for n in trainer.names}
    return {"losses": losses, "g1": g1, "delta": delta}


def compare(got: dict, want: dict) -> dict:
    """The three numbers of the module docstring, with their worst leaves,
    and steadier readings that are not compared (the median leaf's gaps,
    the first step's loss), which ``readings.py`` records."""
    names = sorted(want["g1"])
    g1 = {n: got["g1"].get(n, float("inf")) for n in names}
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    grad_gap, grad_leaf = worst_leaf_gap(g1, want["g1"], names)
    norms = sorted(want["g1"][n] for n in names)
    floor = 1e-3 * norms[len(norms) // 2]
    moved = [n for n in names if want["g1"][n] >= floor]
    delta = {n: got["delta"].get(n, float("inf")) for n in moved}
    change_gap, change_leaf = worst_leaf_gap(delta, want["delta"], moved)
    median_gap = lambda got_, want_, ns: sorted(
        abs(got_[n] - want_[n]) / max(want_[n], 1e-30) for n in ns)[
            len(ns) // 2]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_median_gap": median_gap(g1, want["g1"], names),
            "change_median_gap": median_gap(delta, want["delta"], moved),
            "first_loss_gap": abs(got["losses"][0] / want["losses"][0] - 1),
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "left_out": sorted(set(names) - set(moved))}


def run(ctx) -> dict:
    tr = ctx.cell.traffic
    trainer = Trainer(ctx)
    got = trainer.first_steps(tr["check_steps"], ctx.seed, ctx.device)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    ctx.mark("checked steps")
    setup_s = time.perf_counter() - ctx.started

    stamps = []
    t0 = time.perf_counter()
    n = 0
    while True:
        trainer.step(tr["check_steps"] + n)
        stamps.append(time.perf_counter())
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds and n >= ctx.min_units:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    ctx.log_setup()
    ctx.log_window(stamps, t0)
    res = {"setup_s": setup_s,
           "e2e": {"train_samples_per_s": n * tr["batch"] / window_s},
           "attempted": n * tr["batch"], "failed": 0, "window_s": window_s,
           "units": n}
    if ctx.trace:
        from portbench.harness import trace as tracing
        p = tr["profile_steps"]
        first = tr["check_steps"] + n
        res["data"] = {
            "model": trainer.m, "vocab": trainer.vocab, "batch": tr["batch"],
            "window_s": window_s, "steps": n, "profiled_steps": p,
            "tc": 3, "tp": trainer.m["max_q_length"] + 1,
            "tq": trainer.m["max_q_length"],
            "profiled_batches": [
                {k: v.cpu() for k, v in batch_of(trainer.pool, j).items()
                 if k != "images"} for j in range(first, first + p)]}
        res["trace"] = tracing.profile(
            lambda it=itertools.count(first): trainer.step(next(it)), p)
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                                else 0)

    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = reference_readings(ctx)
    got_vs = compare(got, want)
    ctx.log(f"check: losses {got['losses']} against {want['losses']}; "
            f"worst gradient leaf {got_vs['grad_leaf']}, worst change leaf "
            f"{got_vs['change_leaf']}; left out of the change: "
            f"{got_vs['left_out']}")
    lim = ctx.cell.limits
    res["checks"] = {k: (got_vs[k], lim[k])
                     for k in ("loss_gap", "grad_gap", "change_gap")}
    res["readings"] = {k: v for k, v in got_vs.items()
                       if isinstance(v, float)}
    return res
