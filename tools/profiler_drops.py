"""When does the profiler drop a kernel's records?  Runs on the card.

    python3 tools/profiler_drops.py [--out drops.json]

Takes profiler windows of the flash forward (B 8, H 8, T 512 causal,
scattered pads, Dh 128: 3 calls a window, as ``chip_smoke.py``'s phase 7
does) and of SDPA's forward on the same inputs, in stages: fresh; after
one window of 9,000 small PyTorch kernels; after one window of a
flagship latent train step (as phase 7 profiles it); after
``gc.collect()``; with CUDA activity alone; after 5 s idle; with spin
kernels before and after the calls; and after more train-step windows.
For each window it prints the device kernels ``key_averages()`` holds, the
device events in the profiler's raw result, and the launch calls on the
CPU side (spin kernels counted apart).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]


def window(fn, calls: int, acts=ACTS, fill: int = 0) -> dict:
    """What one profiler window of ``calls`` calls of ``fn`` recorded; with
    ``fill``, ``fill`` spin kernels run before the calls and after them
    (their records are counted apart)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(fill):
            torch.cuda._sleep(100)
        for _ in range(calls):
            fn()
        for _ in range(fill):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    raw = None
    try:
        raw = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == CUDA
                  and "spin_kernel" not in e.name())
    except AttributeError:
        pass
    return {"kernels": sum(e.count for e in avg if e.device_type == CUDA
                           and "spin_kernel" not in e.key),
            "spin": sum(e.count for e in avg if e.device_type == CUDA
                        and "spin_kernel" in e.key),
            "raw_device_events": raw,
            "launch_calls": sum(e.count for e in avg if e.device_type == CPU
                                and "LaunchKernel" in e.key),
            "names": sorted({e.key[:40] for e in avg
                             if e.device_type == CUDA})}


def stage(name: str, fns: dict, windows: int, out: list, acts=ACTS,
          fill: int = 0) -> None:
    for what, (fn, calls) in fns.items():
        rows = [window(fn, calls, acts, fill) for _ in range(windows)]
        out.append({"stage": name, "fn": what, "windows": rows})
        print(f"{name:>22} {what:>5}: kernels "
              f"{[r['kernels'] for r in rows]}, raw device events "
              f"{[r['raw_device_events'] for r in rows]}, launch calls "
              f"{[r['launch_calls'] for r in rows]}"
              + (f", spin {[r['spin'] for r in rows]}" if fill else ""),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write every window's counts here as JSON")
    ap.add_argument("--windows", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profiler_drops: needs a CUDA card")
    dev = torch.device("cuda")
    q, k, v, kv_pad, _ = cs.flash_inputs(dev, 8, 8, 128, 512, 512, True,
                                         cs.SEED, "random")
    allowed = ~kv_pad[:, None, None, :] & ~torch.ones(
        (512, 512), dtype=torch.bool, device=dev).triu(1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"flash": (lambda: cs.fa.flash_attention_fwd(q, k, v, kv_pad,
                                                       True), 3),
           "sdpa": (lambda: torch.nn.functional.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=allowed, scale=1.0), 3)}
    out = []
    stage("fresh", fns, args.windows, out)

    x = torch.zeros(16, device=dev)
    window(lambda: [x.add_(1.0) for _ in range(9000)], 1)
    stage("after 9000 kernels", fns, args.windows, out)

    cfg, kstate, _, _ = cs.flagship_states(dev, {}, 0, einsum=False)
    batch = cs.make_batch(cfg, cs.serve.FLAGSHIP_VOCAB, cs.BATCH,
                          np.random.RandomState(200), dev)
    step = cs.make_train_step(cfg, True)
    g = torch.Generator(dev).manual_seed(1)
    big = window(lambda: step(kstate, batch, g), 1)
    print(f"train step window: {big}", flush=True)
    stage("after a train step", fns, args.windows, out)
    gc.collect()
    stage("after gc.collect", fns, args.windows, out)
    stage("CUDA activity alone", fns, args.windows, out,
          [torch.profiler.ProfilerActivity.CUDA])
    time.sleep(5.0)
    stage("after 5 s idle", fns, args.windows, out)
    # which record goes: the flash kernels, then one small kernel
    y = torch.zeros(16, device=dev)
    order = window(lambda: (fns["flash"][0](), y.add_(1.0)), 3)
    print(f"flash then add_, 3 calls: {order}", flush=True)
    for fill in (8, 64):
        stage(f"with {fill} spin kernels", fns, args.windows, out, fill=fill)
    for i in range(3):
        window(lambda: step(kstate, batch, g), 1)
        stage(f"after {i + 2} train steps", fns, args.windows, out)
    stage("then with 64 spins", fns, args.windows, out, fill=64)
    stage("then with 512 spins", fns, args.windows, out, fill=512)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"train_step_window": big, "stages": out}, fh,
                      indent=1)


if __name__ == "__main__":
    main()
