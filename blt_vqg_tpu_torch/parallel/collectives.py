"""The collectives of a step across processes, and the random draws that
make a sharded step equal the single-process one.

The JAX package writes its step once over global arrays and lets XLA
insert the communication.  Here each rank holds plain local tensors and
the communication is explicit, as differentiable operations (the Megatron
pattern):

- :func:`copy_to` (identity forward, gradient summed over the group) feeds
  a replicated activation to a weight split over the group;
- :func:`reduce_from` (sum forward, identity backward) sums partial outputs
  into a value every rank of the group then uses alike: the output of a
  row-split product, and the sums over the batch of a loss;
- :func:`sync_sum` (sum both ways) is for a sum whose users are rank-local,
  the batch statistics of a train-mode batch norm;
- :func:`gather_from` and :func:`slice_of` move between a split tensor and
  the whole one.

While a sharded step runs, :func:`active` names its mesh.  The losses then
sum over the batch axes (:func:`batch_sum`), and :func:`draw` makes each
random tensor at its global shape and keeps this rank's block, so dropout
masks, crop boxes and latent noise equal the single-process draws from the
same generator.  Without an active mesh every function here is the
identity, or the plain draw.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from blt_vqg_tpu_torch.parallel.mesh import BATCH_AXES

# the axes a draw's dimension may be split over
AXES = {"batch": BATCH_AXES, "model": ("model",), "expert": ("expert",)}
# the meshes of the enclosing steps, innermost last: a context for the
# calls a step makes, as torch.no_grad is for autograd
_ACTIVE: list = []


@contextlib.contextmanager
def active(mesh):
    """Marks ``mesh`` (a mesh across processes, or None) as the one the
    enclosed step is sharded over."""
    _ACTIVE.append(mesh if mesh is not None and mesh.across_processes
                   else None)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current():
    return _ACTIVE[-1] if _ACTIVE else None


def block(n: int, count: int, index: int) -> Tuple[int, int]:
    """(start, stop) of block ``index`` of ``count`` along a dimension of
    ``n``: blocks of ceil(n / count), the last one shorter (JAX's
    uneven sharding)."""
    size = -(-n // count)
    start = min(index * size, n)
    return start, min(start + size, n)


# ---------------------------------------------------------------------------
# plain collectives

def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``group``, as a new tensor.  bf16
    and f16 values are summed in f32 and rounded once, as one product
    over the whole would round them."""
    if group is None:
        return x.detach().clone()
    half = x.dtype in (torch.bfloat16, torch.float16)
    out = (x.detach().float() if half else x.detach().clone()).contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.dtype) if half else out


def _through_all_reduce(x: torch.Tensor, group) -> bool:
    """gloo takes all-reduces of CUDA tensors, and no all-gather of them."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def gather_dim(x: torch.Tensor, group, dim: int, full: int) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block (:func:`block`)
    along ``dim``, of size ``full`` there.  gloo takes no all-gather of
    CUDA tensors: there each rank's block is placed into zeros and the
    copies summed, which is exact."""
    if group is None:
        return x
    dim = dim % x.dim()
    count, index = dist.get_world_size(group), dist.get_rank(group)
    x = x.detach().contiguous()
    if _through_all_reduce(x, group):
        shape = list(x.shape)
        shape[dim] = full
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        start, stop = block(full, count, index)
        out.narrow(dim, start, stop - start).copy_(x)
        return all_reduce(out, group)
    size = -(-full // count)
    if x.shape[dim] < size:
        pad = list(x.shape)
        pad[dim] = size - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(x) for _ in range(count)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, full)


def local_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (no communication)."""
    if group is None:
        return x
    start, stop = block(x.shape[dim], dist.get_world_size(group),
                        dist.get_rank(group))
    return x.narrow(dim, start, stop - start)


# ---------------------------------------------------------------------------
# differentiable collectives

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SyncSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, full):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim, full)

    @staticmethod
    def backward(ctx, g):
        return local_block(g, ctx.group, ctx.dim).contiguous(), None, None, \
            None


class _SliceOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.shape = group, dim, x.shape
        return local_block(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        start, stop = block(ctx.shape[ctx.dim],
                            dist.get_world_size(ctx.group),
                            dist.get_rank(ctx.group))
        full.narrow(ctx.dim, start, stop - start).copy_(g)
        return all_reduce(full, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def sync_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SyncSum.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int, full: int) -> torch.Tensor:
    """The whole tensor from this rank's block along ``dim``; the gradient
    keeps this rank's block (every rank uses the whole tensor alike)."""
    return x if group is None else _GatherFrom.apply(x, group, dim % x.dim(),
                                                     full)


def slice_of(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of a replicated ``x``; the gradient of the whole
    ``x`` is the sum of the ranks' blocks' gradients."""
    return x if group is None else _SliceOf.apply(x, group, dim % x.dim())


# ---------------------------------------------------------------------------
# the batch of the active step

def batch_group():
    mesh = current()
    return None if mesh is None else mesh.group(*BATCH_AXES)


def batch_count() -> int:
    mesh = current()
    return 1 if mesh is None else mesh.axis_size(*BATCH_AXES)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch shards of the active step (a value every
    rank then uses alike)."""
    return reduce_from(x, batch_group())


def batch_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The mean over the global batch of ``x``, whose leading dims (all of
    them, or ``dim``) index this rank's rows."""
    if batch_group() is None:
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    n = x.numel() if dim is None else x.shape[dim]
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    return batch_sum(s) / (n * batch_count())


def draw(fn, shape, generator: Optional[torch.Generator], device,
         dims: Optional[Dict[int, str]] = None, **kw) -> torch.Tensor:
    """``fn(shape, generator=..., device=...)`` (``torch.rand`` or
    ``torch.randn``), drawn at the global shape and cut to this rank's
    block when a sharded step is active.  ``dims`` maps a dimension to the
    axis it is split over ("batch", "model" or "expert"; default: dim 0
    over the batch); the splits are even."""
    mesh = current()
    if mesh is None or generator is None:
        return fn(tuple(shape), generator=generator, device=device, **kw)
    full, cuts = list(shape), []
    for d, axis in (dims if dims is not None else {0: "batch"}).items():
        d = d % len(shape)
        index, count = mesh.coord(*AXES[axis])
        if count > 1:
            full[d] = shape[d] * count
            cuts.append((d, index * shape[d], shape[d]))
    out = fn(tuple(full), generator=generator, device=device, **kw)
    for d, start, n in cuts:
        out = out.narrow(d, start, n)
    return out
