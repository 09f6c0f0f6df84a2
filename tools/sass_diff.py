"""Compares the machine code (SASS) of kernels in two builds of the kernel
library, function by function: for each kernel whose mangled name contains
one of the given patterns, it prints the SASS lines of each build and how
many lines differ (``difflib``), and exits 1 if any kernel differs or is
missing from a build.  It holds a change to the DMAX 256 kernels to leaving
their DMAX 128 siblings' code as it was.  Run on a machine with the CUDA
toolkit (``cuobjdump`` beside nvcc), after building both trees' libraries:

    python3 tools/sass_diff.py A.so B.so ILi128E flash_bwd_dkdv_mma ...

A kernel matches when its name contains every ``+``-joined part of a
pattern (``flash_bwd+ILi128E``).
"""

from __future__ import annotations

import argparse
import difflib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sass_by_function(lib: str) -> dict:
    """{mangled kernel name: its SASS instruction lines} of ``lib``."""
    from blt_vqg_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    funcs = {}
    for block in out.split("Function : ")[1:]:
        lines = block.splitlines()
        funcs[lines[0].strip()] = [ln.strip() for ln in lines[1:]
                                   if ln.strip().startswith("/*")]
    return funcs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("patterns", nargs="+")
    opts = parser.parse_args(argv)
    fa, fb = sass_by_function(opts.a), sass_by_function(opts.b)
    picked = sorted(name for name in set(fa) | set(fb) if any(
        all(part in name for part in pat.split("+"))
        for pat in opts.patterns))
    bad = 0
    for name in picked:
        if name not in fa or name not in fb:
            print(f"{name}: in one build only")
            bad += 1
            continue
        diff = [ln for ln in difflib.unified_diff(fa[name], fb[name], n=0,
                                                  lineterm="")
                if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]
        print(f"{name}: {len(fa[name])} and {len(fb[name])} SASS lines; "
              f"{len(diff)} differ")
        bad += bool(diff)
    if not picked:
        print("no kernel matches")
        return 1
    print(f"{bad} of {len(picked)} kernels differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
