"""Greedy serving on the streaming decode path, closed loop, one client.

The window drives ``make_decode_step(cfg, model, latent_mode=True,
with_probe=False)`` as ``serve.serve_rounds`` does: each batch of
``batch`` requests (images and category contexts, drawn from a pool made
on the device from the seed) is dispatched, its tokens copied to the host,
and only then the next one sent.  Batch i's pool rows and its prior noise
come from generators seeded from (seed, i); the check draws the same again
for the reference.

The check: after the window, a sample of the served requests drawn from
the seed (every request of ``check_batches`` whole batches, so every slot
of a batch is compared, and ``check_requests`` more across the window)
goes through the reference, teacher-forced on the served tokens;
the number compared is the widest gap by which a served token's logit
lies below the reference's best at its position.  With ``ctx.control``
the reference with float8 operands reads the same prompts and tokens, and
the gap of the token it puts first is the control's reading.
"""

from __future__ import annotations

import gc
import itertools
import statistics
import time

import torch

from portbench.harness import program
from portbench.harness.cells import sub_seed
from portbench.harness.weights import make_weights
from portbench.reference import full_precision
from portbench.reference.iq import PAD, RefIQ, fp8_operand


def make_pool(traffic: dict, model: dict, seed: int, device):
    """Requests on the device: images [P, S, S, 3] in [0, 1), contexts
    [P, 3] = <start>, category word, <end>."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, "pool"))
    p, s = traffic["pool"], model["image_size"]
    images = torch.rand((p, s, s, 3), generator=g, device=device)
    cats = torch.randint(0, traffic["categories"], (p,), generator=g,
                         device=device)
    context = torch.stack([torch.ones_like(cats), 6 + cats,
                           torch.full_like(cats, 3)], 1).to(torch.int32)
    return images, context


def batch_rows(traffic: dict, seed: int, i: int, device):
    """The pool rows of batch i."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, "order", i))
    return torch.randint(0, traffic["pool"], (traffic["batch"],),
                         generator=g, device=device)


def p95(values) -> float:
    """The 95th percentile, linear between order statistics (numpy's
    default)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def z_seed(seed: int, i: int) -> int:
    return sub_seed(seed, "z", i)


class Server:
    """The program's model and decode step for one run."""

    def __init__(self, ctx):
        from blt_vqg_tpu_torch.train import step as steps
        cell, dev = ctx.cell, ctx.device
        self.model_cfg = cell.model
        self.vocab = cell.config["vocab_size"]
        cfg = program.port_config(cell.model, {**cell.traffic["overrides"],
                                               **ctx.overrides})
        program.load_library(dev)
        ctx.mark("library")
        self.model = program.build_model(cfg, self.vocab, cell.model,
                                          ctx.seed, dev, cast=True).eval()
        self.decode = steps.make_decode_step(cfg, self.model,
                                             latent_mode=True,
                                             with_probe=False)
        ctx.mark("weights")
        self.images, self.context = make_pool(cell.traffic, cell.model,
                                              ctx.seed, dev)
        ctx.mark("pool")
        self.traffic, self.seed, self.dev = cell.traffic, ctx.seed, dev

    def serve(self, i: int):
        """Batch i, dispatched and returned: (seconds, tokens on the
        host)."""
        t0 = time.perf_counter()
        idx = batch_rows(self.traffic, self.seed, i, self.dev)
        gen = torch.Generator(self.dev).manual_seed(z_seed(self.seed, i))
        out = self.decode(self.images[idx], self.context[idx], gen)
        tokens = out["tokens"].cpu()
        return time.perf_counter() - t0, tokens


def run(ctx) -> dict:
    tr = ctx.cell.traffic
    srv = Server(ctx)
    for i in range(tr["warmup_batches"]):          # every shape, built once
        srv.serve(-1 - i)
    ctx.mark("warm-up")
    setup_s = time.perf_counter() - ctx.started

    spans = None
    if ctx.trace:
        spans = EncoderSpans(srv.model.encoder_cnn)
    lat, stamps, served = [], [], {}
    t0 = time.perf_counter()
    i = 0
    while True:
        dt, tokens = srv.serve(i)
        lat.append(dt)
        stamps.append(time.perf_counter())
        served[i] = tokens
        i += 1
        if (time.perf_counter() - t0 >= ctx.seconds
                and i >= ctx.min_units):
            break
    window_s = time.perf_counter() - t0
    ctx.log_setup()
    ctx.log_window(stamps, t0)
    res = {"setup_s": setup_s,
           "e2e": {"decode_questions_per_s": i * tr["batch"] / window_s,
                   "decode_batch_p95_ms": 1e3 * p95(lat)},
           "attempted": i * tr["batch"], "window_s": window_s,
           "units": i}
    if ctx.trace:
        from portbench.harness import trace as tracing
        res["data"] = {"model": srv.model_cfg, "vocab": srv.vocab,
                       "batch": tr["batch"], "positions":
                       ctx.cell.model["max_decode_length"] + 1,
                       "tc": 3, "window_s": window_s, "batches": i,
                       "spans": {"image_encoder_ms": spans.close()}}
        n = tr["profile_batches"]
        res["trace"] = tracing.profile(
            lambda it=itertools.count(i): srv.serve(next(it)), n)
        res["data"]["profiled_batches"] = n
    res["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if (
        torch.device(ctx.device).type == "cuda") else 0

    del srv.decode, srv.model, srv
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    res.update(check(ctx, served))
    return res


class EncoderSpans:
    """CUDA events around each call of the image encoder (forward hooks),
    read in ms a call when closed; on the CPU, the host clock."""

    def __init__(self, module):
        self.cuda = next(module.parameters()).is_cuda
        self.pairs, self.open = [], None
        self.hooks = [module.register_forward_pre_hook(self._pre),
                      module.register_forward_hook(self._post)]

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _pre(self, mod, args):
        self.open = self._mark()

    def _post(self, mod, args, out):
        self.pairs.append((self.open, self._mark()))

    def close(self) -> list:
        for h in self.hooks:
            h.remove()
        if not self.cuda:
            return [1e3 * (b - a) for a, b in self.pairs]
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def check(ctx, served: dict) -> dict:
    """The reference over a sample of the served requests (module
    docstring); returns attempted/failed counts and the check."""
    tr, m = ctx.cell.traffic, ctx.cell.model
    vocab, dev, b = ctx.cell.config["vocab_size"], ctx.device, tr["batch"]
    failed = sum(int(((t < 0) | (t >= vocab)).any(dim=1).sum())
                 for t in served.values())
    total = len(served) * b
    g = torch.Generator().manual_seed(sub_seed(ctx.seed, "check"))
    whole = torch.randperm(len(served), generator=g)[:tr["check_batches"]]
    picks = {int(w) * b + r for w in whole for r in range(b)}
    picks |= set(torch.randperm(total, generator=g)[
        :tr["check_requests"]].tolist())
    picks, n = sorted(picks), len(picks)
    full_precision()
    images, context = make_pool(tr, m, ctx.seed, dev)
    ref = RefIQ(make_weights(m, vocab, ctx.seed, dev), m, served=True)
    control = (RefIQ(make_weights(m, vocab, ctx.seed, dev), m, served=True,
                     operand=fp8_operand) if ctx.control else None)
    gaps, widest, flips, widest_fp8, tokens = [], 0.0, 0, 0.0, 0
    with torch.no_grad():
        for bi in sorted({p // b for p in picks}):
            rows = [p % b for p in picks if p // b == bi]
            tok = served[bi][rows].to(dev).long()
            if ((tok < 0) | (tok >= vocab)).any():
                widest = float("inf")
                continue
            gen = torch.Generator(dev).manual_seed(z_seed(ctx.seed, bi))
            eps = torch.randn((b, m["latent_dim"]), generator=gen,
                              device=dev)[rows]
            idx = batch_rows(tr, ctx.seed, bi, dev)[rows]
            prefix = torch.cat([torch.full_like(tok[:, :1], PAD),
                                tok[:, :-1]], 1)
            args = (images[idx], context[idx], eps, prefix)
            logits = ref.decode_logits(*args)
            best = logits.max(dim=-1)
            gap = best.values - logits.gather(-1, tok[..., None])[..., 0]
            widest = max(widest, float(gap.max()))
            gaps.append(float(gap.sum()))
            flips += int((best.indices != tok).sum())
            tokens += tok.numel()
            if control is not None:
                first = control.decode_logits(*args).argmax(dim=-1)
                fp8_gap = best.values - logits.gather(-1, first[..., None])[
                    ..., 0]
                widest_fp8 = max(widest_fp8, float(fp8_gap.max()))
    ctx.log(f"check: {n} requests, {tokens} served tokens, {flips} not the "
            f"reference's first, mean gap {sum(gaps) / max(tokens, 1)!r}")
    out = {"failed": failed,
           "checks": {"widest_gap": (widest, ctx.cell.limits["widest_gap"])},
           "readings": {"widest_gap": widest, "flips": flips,
                        "mean_gap": sum(gaps) / max(tokens, 1)}}
    if control is not None:
        out["readings"]["control_widest_gap"] = widest_fp8
    return out
