"""Readings of a cell's check over many seeds in one process, for setting
its limits (never run by the benchmark's own runs):

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control | --fault <kind>] [--seconds 0] [--out FILE]

Sound runs give the lower readings; ``--control`` puts the reference with
every product's operands rounded to float8 e4m3 in the program's place
(serving: it reads the sound run's prompts and served tokens and puts its
own first token at each position; training: it takes the three steps,
the gradient reaching each product rounded to float8 e5m2),
``--override key=value`` runs the program with a setting of the
configuration changed (such as ``stream_weight_dtype=int8``), ``--fault``
plants one of ``harness/faults.py``'s faults.  Each seed prints one JSON
line of the numbers compared (and appends it to ``--out``).  Each seed pays its own
set-up but not the process's start and the library's load.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness import cells, faults  # noqa: E402
from portbench.harness.runner import RunContext  # noqa: E402


def reading(cell, seed: int, seconds: float, control: bool, fault,
            device: str, overrides: dict) -> dict:
    import torch
    ctx = RunContext(cell, seed, seconds, False, device, time.perf_counter(),
                     overrides=overrides)
    entry = cell.traffic["entry"]
    if control and entry == "train_step":
        from portbench.entries import train_step
        from portbench.reference.iq import fp8_gradient, fp8_operand
        got = train_step.reference_readings(ctx, operand=fp8_operand,
                                              gradient=fp8_gradient)
        want = train_step.reference_readings(ctx)
        out = train_step.compare(got, want)
        return {"readings": {k: v for k, v in out.items()
                             if isinstance(v, float)},
                "leaves": [out["grad_leaf"], out["change_leaf"]]}
    ctx.control = control
    mod = cells.entry(cell.traffic)
    t0 = time.perf_counter()
    if fault:
        with faults.plant(fault, entry):
            res = mod.run(ctx)
    else:
        res = mod.run(ctx)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    return {"readings": res["readings"],
            "e2e": res["e2e"], "setup_s": res["setup_s"],
            "memory_peak_bytes": res["memory_peak_bytes"],
            "units": res["units"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = cells.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        over = {k: json.loads(v) if v[:1] in "0123456789-[{tf" else v
                for k, v in (o.split("=", 1) for o in args.override)}
        line = dict(reading(cell, seed, args.seconds, args.control,
                            args.fault, args.device, over),
                    workload=args.workload, seed=seed,
                    kind=("control" if args.control else
                          args.fault or "sound"), overrides=over)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
