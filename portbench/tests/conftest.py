"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from
the repo root (tests marked ``cuda`` run only with a card)."""

import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import cells  # noqa: E402
from portbench.harness.runner import RunContext  # noqa: E402

TINY_MODEL = dict(emb_dim=16, hidden_dim=32, latent_dim=24, pwffn_dim=64,
                  num_layers=2, num_heads=4, image_size=32, max_q_length=10,
                  max_decode_length=12, dtype="float32")
TINY_TRAFFIC = {"serve_stream": dict(batch=4, pool=16, warmup_batches=1,
                                     profile_batches=1),
                "train_step": dict(batch=8, pool_batches=4, min_words=3,
                                   max_words=8, profile_steps=1)}


def tiny(cell: cells.Cell, **model) -> cells.Cell:
    """``cell`` at a size the CPU holds: the widths of ``TINY_MODEL``, a
    50-word vocabulary, float32 products, small batches."""
    cell = copy.deepcopy(cell)
    cell.config["model"] = dict(cell.config["model"],
                                **dict(TINY_MODEL, **model))
    cell.config["vocab_size"] = 50
    cell.traffic = dict(cell.traffic,
                        **TINY_TRAFFIC[cell.traffic["entry"]])
    return cell


def context(cell, seed=7, trace=False, units=2, **kw) -> RunContext:
    return RunContext(cell, seed, 0.0, trace, "cpu", time.perf_counter(),
                      min_units=units, log=lambda s: None, **kw)


@pytest.fixture(scope="session")
def bench():
    return cells.benchmark()


@pytest.fixture()
def card():
    """Skips unless a CUDA card is present (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
