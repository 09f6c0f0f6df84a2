"""Faults planted in the program, to show that the check catches them.

Each is a context manager that replaces one function of the program for
its duration:

- ``unchanged``: a step that returns its state unchanged (serving: the
  stack step's new keys and values come back as zeros, so the caches never
  change; training: the real step runs and reports its loss, and its
  parameters, buffers and optimizer state are put back as they were);
- ``half_batch``: half of the batch left out (serving: the first half is
  decoded and its answers fill the rest; training: the step takes the first
  half of the rows, and its means are over them);
- ``token``: a served token altered where the head produces it (row 0 at
  every position: one slot of a batch, which the check's whole batches
  always hold).
"""

from __future__ import annotations

import contextlib
import functools


@contextlib.contextmanager
def _patched(module, name: str, make):
    """``module.name`` replaced by ``make(orig)``, which takes over the
    original's attributes (the program counts launches on its kernels'
    functions)."""
    orig = getattr(module, name)
    setattr(module, name, functools.update_wrapper(make(orig), orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _stack_unchanged(orig):
    import torch

    def fn(*args, **kw):
        x, k, v = orig(*args, **kw)
        return x, torch.zeros_like(k), torch.zeros_like(v)
    return fn


def _decode_half(orig):
    import torch

    def make(*args, **kw):
        step = orig(*args, **kw)

        def half(images, context, generator=None, **more):
            h = images.shape[0] // 2
            out = step(images[:h], context[:h], generator, **more)
            return {k: torch.cat([v, v], 0) for k, v in out.items()}
        return half
    return make


def _head_token(orig):
    def fn(*args, **kw):
        tokens = orig(*args, **kw).clone()
        vocab = args[3].shape[1]
        tokens[0] = (tokens[0] + 1) % vocab
        return tokens
    return fn


def _train_unchanged(orig):
    import torch

    def tensors(state):
        o = state.opt_state
        return list(state.model.state_dict().values()) + [
            v for d in (o.mu, o.nu, o.master) for v in d.values()
            if isinstance(v, torch.Tensor)]

    def make(*args, **kw):
        step = orig(*args, **kw)

        def unchanged(state, batch, generator, eps=None):
            before = (state.step, state.kliter, state.opt_state)
            saved = [(t, t.clone()) for t in tensors(state)]
            state, metrics = step(state, batch, generator, eps)
            with torch.no_grad():
                for t, copy in saved:
                    t.copy_(copy)
            state.step, state.kliter, state.opt_state = before
            return state, metrics
        return unchanged
    return make


def _train_half(orig):
    def make(*args, **kw):
        step = orig(*args, **kw)

        def half(state, batch, generator, eps=None):
            h = batch["images"].shape[0] // 2
            return step(state, {k: v[:h] for k, v in batch.items()},
                        generator, None if eps is None else eps[:h])
        return half
    return make


def plant(kind: str, entry: str):
    """The fault ``kind`` for the traffic entry ``entry``."""
    from blt_vqg_tpu_torch.ops.kernels import decode_head, decode_stream
    from blt_vqg_tpu_torch.train import step
    table = {
        ("unchanged", "serve_stream"): (decode_stream, "decode_stack_step",
                                        _stack_unchanged),
        ("half_batch", "serve_stream"): (step, "make_decode_step",
                                         _decode_half),
        ("token", "serve_stream"): (decode_head, "head_argmax", _head_token),
        ("unchanged", "train_step"): (step, "make_train_step",
                                      _train_unchanged),
        ("half_batch", "train_step"): (step, "make_train_step", _train_half),
    }
    return _patched(*table[(kind, entry)])


FAULTS = {"serve_stream": ("unchanged", "half_batch", "token"),
          "train_step": ("unchanged", "half_batch")}
