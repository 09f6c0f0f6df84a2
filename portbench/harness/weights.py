"""Seed-made weights for the program and the reference.

Every parameter of the reference's :func:`param_spec` is made on the
device: the normal ones as slices of one ``torch.randn`` call under a
generator seeded from the run's seed, scaled per leaf; norms' scales and
batch-norm variances one, biases and means zero.  The same seed gives the
same tensors, so the reference, which runs after the program's state is
freed, makes them again instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.harness.cells import sub_seed
from portbench.reference.iq import param_spec


def make_weights(model: dict, vocab: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    spec = param_spec(model, vocab)
    normal = [(n, s, std) for n, s, init, std in spec if init == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, std in normal:
        k = math.prod(shape)
        out[name] = flat[off:off + k].view(shape).mul_(std)
        off += k
    for name, shape, init, _ in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
    return out
