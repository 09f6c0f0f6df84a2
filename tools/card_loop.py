"""Repeats card test cases many times and counts what fails, with every
assertion message: for a failure seen once in a full card run.

By default it runs each of the 12 cases of
``tests/test_torch_kernels_cuda.py::test_self_attn_step_cluster_kernel``
``--calls`` times (the kernel check and the profiler's launch check), then,
where the CUDA toolkit has ``compute-sanitizer``, runs ``--tool racecheck``
and ``--tool synccheck`` on one call of each cluster kernel (the bf16
``self_attn_step`` and ``head_argmax`` at the flagship's widths) and prints
the sanitizers' summaries, or that the tool is absent.

Run from the repository root on a machine with the card and nvcc:

    python3 tools/card_loop.py [--calls 200] [--cases I ...] [--no-sanitizer]
"""

from __future__ import annotations

import argparse
import collections
import os
import shutil
import signal
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

# one call of each cluster kernel, for the sanitizers
SANITIZE = r'''
import sys, torch
sys.path.insert(0, "tests")
import test_torch_kernels_cuda as t
from blt_vqg_tpu_torch.ops.kernels import decode_head as tdh
from blt_vqg_tpu_torch.ops.kernels import decode_layer as tdl
dev = torch.device("cuda", 0)
args, _, kp = t._layer_inputs(dev, torch.bfloat16, (64, 8, 128, 8, 51, 25, True), seed=89)
tdl.self_attn_step(*args, 25, 8, key_pad=kp)
for q in (True, False):
    (x, s, b, w, bias), sc, chunk = t._head_inputs(dev, torch.bfloat16, 64, 1024, 12000, q, 7)
    tdh.head_argmax(x, s, b, w, bias, chunk=chunk, scales=sc)
torch.cuda.synchronize()
print("sanitized calls done")
'''


def sanitizer() -> str | None:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "compute-sanitizer")
    return path if os.path.exists(path) else shutil.which("compute-sanitizer")


def loop(calls: int, cases) -> bool:
    import test_torch_kernels_cuda as t

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    clean = True
    for i, case in enumerate(t.SELF_CLUSTER_CASES):
        if cases and i not in cases:
            continue
        fails = collections.Counter()
        t0 = time.perf_counter()
        for _ in range(calls):
            try:
                t.test_self_attn_step_cluster_kernel(dev, case)
            except Exception as e:  # noqa: BLE001 - every failure is counted
                where = traceback.extract_tb(e.__traceback__)[-1]
                fails[f"{type(e).__name__} at {os.path.basename(where.filename)}:"
                      f"{where.lineno} ({where.line}): {e}"] += 1
        clean &= not fails
        print(f"test_self_attn_step_cluster_kernel{list(case)}: {calls} calls, "
              f"{sum(fails.values())} failed, {time.perf_counter() - t0:.1f} s"
              + "".join(f"\n    {n} x {msg}" for msg, n in fails.items()),
              flush=True)
    return clean


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=200)
    parser.add_argument("--cases", type=int, nargs="*", default=[],
                        help="indices into SELF_CLUSTER_CASES (default: all)")
    parser.add_argument("--no-sanitizer", action="store_true")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from blt_vqg_tpu_torch.ops.kernels import _build

    _build.library()  # a failed build stops here, not in every call
    clean = loop(opts.calls, opts.cases)
    if not opts.no_sanitizer:
        tool = sanitizer()
        if tool is None:
            print("compute-sanitizer: not found in the CUDA toolkit or on PATH")
        for check in ("racecheck", "synccheck") if tool else ():
            proc = subprocess.Popen([tool, "--tool", check, sys.executable,
                                     "-c", SANITIZE], cwd=ROOT, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                text = proc.communicate(timeout=300)[0].strip().splitlines()
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                print(f"compute-sanitizer --tool {check}: no result in 300 s")
                continue
            print(f"compute-sanitizer --tool {check}: exit {proc.returncode}; "
                  f"last lines:\n    " + "\n    ".join(text[-12:]), flush=True)
    print(f"loop {'clean' if clean else 'had failures'}")


if __name__ == "__main__":
    main()
