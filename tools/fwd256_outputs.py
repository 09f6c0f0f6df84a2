"""Saves, or compares, the outputs of the two head-dim-256 bf16 forwards on
seed-made inputs: ``flash_attention_fwd`` (o, m, l) at the four training
shapes (B 64, H 4, Dh 256: Tq x Tk 3 x 3, 21 x 21, 20 x 20 causal, 20 x 3,
trailing key pads) and at B 8, T 512 causal with scattered pads, and the
one-way and two-way ring forwards (o, m, l) at B 64, T 20 on seq 4 and at
B 2, T 4096 on seq 4 (causal).  To hold two trees' kernels to each other,
run ``save`` with each tree's package, then ``compare``; it prints, per
output, whether the two are equal bit for bit, and the largest difference
where they are not.  Run on a machine with the card and nvcc:

    python3 tools/fwd256_outputs.py save OUT.pt    # the tree it sits in
    python3 tools/fwd256_outputs.py compare A.pt B.pt
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, D = 4, 256
FLASH = [(64, 3, 3, False), (64, 21, 21, False), (64, 20, 20, True),
         (64, 20, 3, False), (8, 512, 512, True)]     # (B, Tq, Tk, causal)
RING = [(64, 4, 5), (2, 4, 1024)]                     # (B, ranks, chunk)


def _inputs(dev, b, tq, tk, seed, scattered):
    g = torch.Generator(dev).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    q = (n(b, tq, H, D) * D ** -0.5).to(torch.bfloat16)
    k, v = (n(b, tk, H, D).to(torch.bfloat16) for _ in range(2))
    if scattered:
        pad = torch.rand((b, tk), generator=g, device=dev) < 0.3
        pad[:, 0] = False
    else:
        lengths = torch.randint(1, tk + 1, (b,), generator=g, device=dev)
        pad = torch.arange(tk, device=dev)[None, :] >= lengths[:, None]
    return q, k, v, pad.contiguous()


def save(path: str) -> None:
    from blt_vqg_tpu_torch.ops.kernels import flash_attention as fa
    from blt_vqg_tpu_torch.ops.kernels import ring_attention as ra
    from blt_vqg_tpu_torch.parallel import build_mesh

    dev = torch.device("cuda")
    out = {}
    for i, (b, tq, tk, causal) in enumerate(FLASH):
        q, k, v, pad = _inputs(dev, b, tq, tk, 100 + i, tq > 64)
        for name, t in zip("oml", fa.flash_attention_fwd(q, k, v, pad,
                                                         causal)):
            out[f"flash B{b} {tq}x{tk} {name}"] = t.cpu()
    for i, (b, n, c) in enumerate(RING):
        q, k, v, pad = _inputs(dev, b, n * c, n * c, 200 + i, False)
        ring = build_mesh((n,), ("seq",), dev).ring()
        shards = [x.view(b, n, c, *x.shape[2:]).transpose(0, 1)
                  for x in (q, k, v, pad)]
        for fwd in ("ring_attention_fwd_shard",
                    "ring_attention_fwd_bidir_shard"):
            got = getattr(ra, fwd)(*shards, ring=ring, causal=True,
                                   return_lse=True)
            for name, t in zip("oml", got):
                out[f"{fwd} B{b} C{c} {name}"] = t.cpu()
    torch.save(out, path)
    print(f"saved {len(out)} outputs to {path}")


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    bad = 0
    for key in sorted(set(a) | set(b)):
        if key not in a or key not in b:
            print(f"{key}: in one file only")
            bad += 1
        elif torch.equal(a[key], b[key]):
            print(f"{key}: equal bit for bit")
        else:
            diff = (a[key].float() - b[key].float()).abs()
            print(f"{key}: {int((a[key] != b[key]).sum())} of "
                  f"{a[key].numel()} differ, largest {float(diff.max()):.4g}")
            bad += 1
    print(f"{bad} of {len(set(a) | set(b))} outputs differ")
    return 1 if bad else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("save")
    sv.add_argument("path")
    cmp = sub.add_parser("compare")
    cmp.add_argument("a")
    cmp.add_argument("b")
    opts = parser.parse_args(argv)
    if opts.cmd == "save":
        save(opts.path)
        return 0
    return compare(opts.a, opts.b)


if __name__ == "__main__":
    sys.exit(main())
