"""GPipe over a ``pipe`` mesh axis (counterpart of
``blt_vqg_tpu/parallel/pipeline.py``).

The layer stack is split into ``pipe`` contiguous stages and the batch into
microbatches; stage s holds layers ``[s*L/S, (s+1)*L/S)`` and at tick t runs
microbatch t - s, so the pipe fills and drains in m + S - 1 ticks.  Each
process is one stage (``parallel/mesh.py``: ``pipe`` spans processes) and
keeps the whole model, as the JAX package passes the stack replicated; the
layers around the stack run alike on every stage.

- Activations hop to the next stage through the ``pipe`` ring's
  differentiable ``permute`` (``lax.ppermute``), so the backward is autograd
  through the schedule: the gradients hop back through the permutes' own
  backward, the reverse pipeline.  A hop is a collective of the stages, so
  every stage must run the same hops backward in the same order.  The
  schedule makes each stage's graph one chain: every tick's input is tied
  to the previous hop's output (``_Tie``: the stage's input is one of the
  two, the other gets a zero gradient), a bubble tick passes its input on
  unchanged (one process per stage: no compute on garbage), and the
  stack's output depends on its last link on every stage (``_Broadcast``).
  The chain starts from zeros tied to the stage's parameters, ``x`` and
  the side inputs: a backward that asks for the gradient of anything the
  pipeline reads (``torch.autograd.grad`` runs only the nodes on a path to
  what it is asked for) then runs every link on every stage.
- Batch-aligned side inputs (the encoder output, the masks) are cut into
  the microbatches of ``x``.  Their gradients, and that of ``x``, are
  partial on each stage (each stage's layers use them): ``_StageSum`` sums
  them over ``pipe`` in one node that runs after the whole chain.
- Every stage ends with the whole output: the last stage broadcasts it (the
  JAX ``psum`` of the one real copy).  The layers downstream run alike on
  every stage, so each has the same output gradient; the broadcast's
  backward keeps it on the last stage alone, and the loss is not counted
  once per stage.
- The layers' parameter gradients are non-zero on their own stage only;
  the train step sums them over ``pipe`` (``train/step.py``
  ``reduce_gradients``) before the update.
- Dropout draws from a generator per (global layer, microbatch), seeded
  from the caller's generator's seed (the JAX ``fold_in`` stream), so the
  masks are the same whatever the stage count, and differ from the
  sequential stack's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from blt_vqg_tpu_torch.core.rng import _MASK64, _mix
from blt_vqg_tpu_torch.parallel import collectives as col
from blt_vqg_tpu_torch.parallel.mesh import PIPE


class _Tie(torch.autograd.Function):
    """``keep``, with ``also`` kept in the graph (their gradients zero)."""

    @staticmethod
    def forward(ctx, keep, *also):
        ctx.like = [(a.shape, a.dtype) for a in also]
        return keep.view_as(keep)

    @staticmethod
    def backward(ctx, g):
        return (g, *[g.new_zeros(shape, dtype=dt) for shape, dt in ctx.like])


class _StageSum(torch.autograd.Function):
    """The identity forward; the gradients summed over ``pipe`` backward,
    every input in one node, absent ones as zeros."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *[col.all_reduce(
            g if g is not None else torch.zeros(shape, dtype=dt, device=dev),
            ctx.group) for g, (shape, dt, dev) in zip(gs, ctx.like)])


class _Broadcast(torch.autograd.Function):
    """The last stage's ``out`` on every stage; ``tail`` (the stage's last
    link) only ties the chain to the output.  Backward: the output's
    gradient on the last stage, zero elsewhere."""

    @staticmethod
    def forward(ctx, out, tail, group, src, last, shape):
        ctx.last, ctx.tail = last, (tail.shape, tail.dtype)
        if last:
            result = out.contiguous().clone()
        else:
            result = torch.empty(shape, dtype=tail.dtype, device=tail.device)
        dist.broadcast(result, src, group=group)
        return result

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.tail
        return (g if ctx.last else None, g.new_zeros(shape, dtype=dtype),
                None, None, None, None)


def _split(a: Optional[torch.Tensor], batch: int, m: int):
    """``a`` cut into ``m`` microbatches along its leading (batch) dim; a
    tensor broadcast over the batch (leading dim 1) or None goes whole to
    each."""
    if a is None or a.shape[0] != batch:
        return [a] * m
    return list(a.reshape(m, batch // m, *a.shape[1:]).unbind(0))


def _layer_generator(generator: Optional[torch.Generator], layer: int,
                     microbatch: int) -> Optional[torch.Generator]:
    """The generator of (global layer, microbatch), seeded from
    ``generator``'s own seed (JAX: ``fold_in(fold_in(key, layer),
    microbatch)``), which leaves ``generator``'s state as the sequential
    stack leaves it; None without a generator."""
    if generator is None:
        return None
    seed = _mix(_mix(generator.initial_seed() ^ (layer & _MASK64))
                ^ (microbatch & _MASK64))
    return torch.Generator(generator.device).manual_seed(seed >> 1)


def pipeline_apply(layer_fn: Callable, layer_params: Sequence, x: torch.Tensor,
                   mesh, *, microbatches: int, axis: str = PIPE,
                   batch_args: Sequence = (),
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Applies the L layers of ``layer_params`` to ``x`` [B, ...] (this
    rank's rows of the batch) as a pipeline over ``axis``.

    ``layer_fn(i, x_mb, batch_args_mb, generator_i) -> x_mb`` applies
    global layer ``i`` to one microbatch; ``layer_params[i]`` are the
    tensors layer i reads (the JAX ``stacked_params``: they tie each
    stage's schedule into the graph); ``batch_args`` are tensors (or None)
    whose leading dim is the batch, cut into the same microbatches as
    ``x``; ``generator_i`` is the (layer, microbatch) generator of the
    stream drawn from ``generator``, or None.  Returns the stack's output
    on every stage, equal to the sequential application of the layers."""
    if mesh is None or axis not in mesh.shape:
        raise ValueError(f"mesh has no '{axis}' axis: "
                         f"{None if mesh is None else dict(mesh.shape)}")
    stages = mesh.shape[axis]
    num_layers = len(layer_params)
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers not divisible by {stages} "
                         f"pipeline stages")
    b, m = x.shape[0], microbatches
    if b % m:
        raise ValueError(f"per-data-shard batch {b} not divisible by {m} "
                         f"microbatches")
    per = num_layers // stages
    s = mesh.coords[axis] if stages > 1 else 0
    last = s == stages - 1
    group = mesh.group(axis)
    grad = torch.is_grad_enabled()
    batch_args = list(batch_args)
    if stages > 1 and grad:
        held = [i for i, a in enumerate(batch_args)
                if a is not None and a.is_floating_point()]
        x, *summed = _StageSum.apply(group, x,
                                     *[batch_args[i] for i in held])
        for i, a in zip(held, summed):
            batch_args[i] = a
    xm = _split(x, b, m)
    bargs = [_split(a, b, m) for a in batch_args]

    def stage(inp, mb):
        for i in range(s * per, (s + 1) * per):
            inp = layer_fn(i, inp, tuple(a[mb] for a in bargs),
                           _layer_generator(generator, i, mb))
        return inp

    if stages == 1:
        return torch.cat([stage(xm[mb], mb) for mb in range(m)])
    ring = mesh.ring(axis)
    seen = {}
    for i in range(s * per, (s + 1) * per):
        for t in layer_params[i]:
            seen.setdefault(id(t), t)
    roots = [x, *[a for a in batch_args if a is not None
                  and a.is_floating_point()], *seen.values()]
    buf = _Tie.apply(torch.zeros_like(xm[0]), *roots)    # the chain's root
    banked = []
    ticks = m + stages - 1
    y = buf
    for t in range(ticks):
        mb = t - s
        xt = xm[min(t, m - 1)]
        inp = _Tie.apply(xt, buf) if s == 0 else _Tie.apply(buf, xt)
        if 0 <= mb < m:
            y = stage(inp, mb)
            if last:
                banked.append(y)
        else:
            y = inp
        if t < ticks - 1:
            buf = ring.permute(y, 1)
    out = torch.cat(banked) if last else y.new_empty(0)
    return _Broadcast.apply(out, y, group, ring.members[-1], last,
                            (b, *x.shape[1:]))
