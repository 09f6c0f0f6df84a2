"""One run of one cell: set-up, window, trace, check, one JSON line.

The last line of standard output is the result; the numbers the check
compared, each beside its limit, are the last lines of standard error and
the result's last key, ``checks``.  A run without the cards the cell asks
for, or that finds JAX or the JAX package loaded once the window has
closed, prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

from portbench.harness import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "blt_vqg_tpu")


@dataclass
class RunContext:
    cell: cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float
    overrides: dict = field(default_factory=dict)
    control: bool = False
    min_units: int = 1
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr,
                                                 flush=True)
    marks: list = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Ends the set-up phase ``phase`` (logged by ``log_setup``)."""
        self.marks.append((phase, time.perf_counter()))

    def log_setup(self) -> None:
        """One line: the seconds of each set-up phase since the start."""
        t, parts = self.started, []
        for phase, at in self.marks:
            parts.append(f"{phase} {at - t:.3f}")
            t = at
        self.log("setup s: " + ", ".join(parts))

    def log_window(self, stamps: list, t0: float, parts: int = 6) -> None:
        """One line: the units (batches, steps) completed in each sixth of
        the window, from the host-clock ``stamps`` of their completion;
        a run that is slow all through differs from one with a stall."""
        if not stamps:
            return
        span = (stamps[-1] - t0) / parts
        counts = [0] * parts
        for s in stamps:
            counts[min(int((s - t0) / span), parts - 1)] += 1
        self.log(f"window: units per {span:.2f} s: {counts}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    whole name compared (``blt_vqg_tpu_torch`` is not ``blt_vqg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description="Runs one cell of "
                                "BENCHMARK.json once and prints one JSON line")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metric_values(cell: cells.Cell, res: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics, as {name: {"value", "unit"}}; a reader that finds nothing to
    read leaves its metric out."""
    out = {}
    if not trace:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for m in cell.end_to_end:
            if m["name"] in values:
                out[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        return out
    data = dict(res.get("data", {}), trace=res.get("trace"))
    for m in cell.per_layer:
        v = cells.reader(m["name"])(data)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(cell: cells.Cell, res: dict, trace: bool, device: dict) -> dict:
    checks = res["checks"]
    correct = (res["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values()))
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"],
           "metrics": metric_values(cell, res, trace), "device": device}
    if trace and res.get("trace") is not None:
        from portbench.harness.trace import breakdown
        t = res["trace"]
        out["device"] = dict(device, busy_s=t.busy_s(), window_s=t.window_s)
        out["breakdown"] = breakdown(t)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None, started: float = 0.0) -> int:
    args = parse(argv)
    cell = cells.find_cell(args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {cards}", file=sys.stderr)
        return 2
    ctx = RunContext(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", started)
    ctx.mark("import")
    torch.zeros(1, device=ctx.device)
    ctx.mark("cuda context")
    res = cells.entry(cell.traffic).run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = result(cell, res, bool(args.trace), device)
    print(f"correct {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
