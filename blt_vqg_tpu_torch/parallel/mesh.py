"""The mesh of the port (counterpart of ``blt_vqg_tpu/parallel/mesh.py``)
and the transport of its rings.

:func:`build_mesh` returns a :class:`Mesh` whose ``shape`` is an ``{axis:
size}`` mapping, as a ``jax.sharding.Mesh``'s is, so the attention gate can
read ``mesh.shape.get("seq", 1)``.  Its axes over 1 span processes, one per
card: the mesh lays the ``torch.distributed`` world out row-major over the
axes as named (``model`` innermost in the default ``("data", "model")``,
as in the JAX package), and builds one process group per axis and per set
of axes that a step reduces over (:meth:`Mesh.group`).  ``train/step.py``
and ``parallel/sharding.py`` make the collectives over them.  The axes:

- ``data``, ``dcn_data`` (the batch), ``model`` and ``expert`` (the
  weights);
- ``seq``: the ring of ``ops/ring_attention.py``.  Beside ``data`` and
  ``model`` its ranks are processes (:class:`ProcessRing`); alone, in a
  world of one process, its n ranks are shards held on one device by that
  process (:class:`LocalRing`);
- ``pipe``: the stages of GPipe (``parallel/pipeline.py``), beside the
  batch axes only: a stage runs its layers whole, as the JAX package's
  ``shard_map`` over ``pipe`` does.

Both rings keep the protocol of the TPU ring kernels
(ops/pallas/ring_attention.py): a :class:`Channel` is a double-buffered
pair of slots per rank held, a hop moves each held rank's current slot into
the next rank's other slot, ``slot(step)`` waits for the hop that filled a
slot (the TPU's receive semaphore), a hop never overwrites a slot before
the compute that last read it (the TPU's credit), and ``join`` completes
every hop before any buffer is released.

- :class:`LocalRing`: a hop is a real copy of every rank's slot.  On CUDA
  the copies run on a side stream ordered by CUDA events (the receive wait
  and the credit); on the CPU they are synchronous.  Every buffer a hop
  touches is allocated on the compute stream before the first hop, and
  :meth:`LocalRing.join` makes the compute stream wait for the side
  stream, so the caching allocator never hands a buffer back while a copy
  may still use it.
- :class:`ProcessRing`: each process holds its own rank's slots, and a hop
  is ``torch.distributed`` point-to-point (``batch_isend_irecv``) over the
  axis's process group.  NCCL sends CUDA tensors directly: its stream
  waits for the compute stream when a hop is issued (the credit: a hop is
  issued after the compute that last read its slot), and ``slot`` makes
  the compute stream wait for the receive.  gloo's point-to-point moves
  host memory, so on CUDA tensors the gloo transport stages each hop
  through pinned host buffers (chosen from the group's backend: gloo is
  what two processes sharing one card can use, since NCCL refuses two
  ranks on one GPU); on CPU tensors it sends them directly.

:meth:`ProcessRing.permute` is the differentiable hop, the counterpart of
``lax.ppermute`` and its transpose: the gradient goes back the other way.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

SEQ = "seq"
PIPE = "pipe"
BATCH_AXES = ("dcn_data", "data")   # the batch shards over both, outer first
TP_AXES = ("model", "expert")       # the weights split over these


class Channel:
    """Double-buffered slots of one ring direction: for each payload, a
    tensor [2, n, *shape]; ``slot(step)`` is the [n, *shape] half that
    holds, for every rank, the block it computes on at ``step``."""

    def __init__(self, ring: "LocalRing", payloads: Sequence[Tuple],
                 direction: int):
        self.ring, self.direction = ring, direction
        self.bufs = [torch.empty((2, ring.n, *shape), dtype=dtype,
                                 device=ring.device)
                     for shape, dtype in payloads]
        self._credit = None       # compute-stream event (see release)
        self._landed = [None, None]

    def seed(self, *tensors) -> None:
        """Slot 0 of each payload := the ranks' own blocks (None: zeros)."""
        for buf, t in zip(self.bufs, tensors):
            if t is None:
                buf[0].zero_()
            else:
                buf[0].copy_(t)
        self.release()

    def release(self) -> None:
        """Marks the compute issued so far on these slots: the next hop
        waits for it before it overwrites a slot (the TPU's credit)."""
        self._credit = self.ring._record()

    def slot(self, step: int) -> Tuple[torch.Tensor, ...]:
        """The slots computed on at ``step``; the compute stream first
        waits for the hop that filled them (the TPU's receive wait)."""
        ev = self._landed[step % 2]
        if ev is not None:
            torch.cuda.current_stream(self.ring.device).wait_event(ev)
            self._landed[step % 2] = None
        return tuple(buf[step % 2] for buf in self.bufs)

    def send(self, step: int, hops: int = 1, out=None) -> None:
        """Copies each rank r's slot ``step % 2`` into rank
        r + hops * direction's slot ``(step + 1) % 2``, or into ``out`` (a
        tensor [n, *shape] per payload: the direct return of a rider to its
        home rank)."""
        src = step % 2
        dst = out if out is not None else [buf[1 - src] for buf in self.bufs]
        with self.ring._side(self._credit):
            for buf, d in zip(self.bufs, dst):
                self.ring._roll_copy(d, buf[src], hops * self.direction)
            ev = self.ring._record()
        if out is None:
            self._landed[1 - src] = ev


class LocalRing:
    """The ring of one mesh axis: ``n`` ranks on one ``device``, all held
    by this process (``rank`` None: the ring's tensors stack every rank on
    their leading axis).  Counts the bytes its hops move in
    ``hop_bytes``."""

    rank = None

    def __init__(self, n: int, device):
        self.n, self.device = n, _indexed(device)
        self.held = n
        self.hop_bytes = 0
        self._stream = None

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def check(self, *tensors) -> None:
        for t in tensors:
            if t is not None and t.device != self.device:
                raise ValueError(f"ring of {self.n} ranks on {self.device} "
                                 f"got a tensor on {t.device}")

    def channel(self, payloads: Sequence[Tuple], direction: int) -> Channel:
        """A channel of (shape, dtype) payloads per rank; ``direction`` +1
        sends to rank r + 1 (clockwise), -1 to rank r - 1."""
        return Channel(self, payloads, direction)

    def permute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """x [n, ...] with rank r's block moved to rank r + shift, as a new
        tensor (differentiable; the counterpart of ``lax.ppermute``)."""
        self.hop_bytes += x.numel() * x.element_size()
        return torch.roll(x, shift, dims=0)

    def join(self) -> None:
        """The compute stream waits for every hop issued so far."""
        if self.on_cuda and self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

    # ---- internals
    def _record(self):
        if not self.on_cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _side(self, after):
        """A context on the side stream that first waits for ``after``."""
        if not self.on_cuda:
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if after is not None:
            self._stream.wait_event(after)
        return torch.cuda.stream(self._stream)

    def _roll_copy(self, dst, src, shift: int) -> None:
        """dst[(r + shift) % n] = src[r] for every rank r: two copies."""
        k = shift % self.n
        if k == 0:
            dst.copy_(src)
        else:
            dst[k:].copy_(src[:self.n - k])
            dst[:k].copy_(src[self.n - k:])
        self.hop_bytes += src.numel() * src.element_size()


class _Recv:
    """A hop in flight: ``finish`` waits for its requests (a coalescing
    backend returns one request for the whole batch, so sends and receives
    are waited for together) and, on the staged transport, copies the host
    buffers into their destinations.  Finishing twice does nothing."""

    def __init__(self, works, staged):
        self.works, self.staged = works, staged   # staged: [(host, dst)]

    def finish(self) -> None:
        for w in self.works:
            w.wait()
        for host, dst in self.staged:
            dst.copy_(host)
        self.works, self.staged = [], []


class ProcessChannel:
    """One ring direction across processes: this rank's two slots per
    payload, a tensor [2, 1, *shape] each; ``slot(step)`` is the [1,
    *shape] half it computes on at ``step``.  The protocol of
    :class:`Channel`."""

    def __init__(self, ring: "ProcessRing", payloads: Sequence[Tuple],
                 direction: int):
        self.ring, self.direction = ring, direction
        self.bufs = [torch.empty((2, 1, *shape), dtype=dtype,
                                 device=ring.device)
                     for shape, dtype in payloads]
        self.tag = ring._next_tag(len(payloads))
        self._landing = [None, None]          # the _Recv filling each slot

    def seed(self, *tensors) -> None:
        """Slot 0 of each payload := this rank's own block (None: zeros)."""
        for buf, t in zip(self.bufs, tensors):
            if t is None:
                buf[0].zero_()
            else:
                buf[0].copy_(t)

    def release(self) -> None:
        """Nothing to record: a hop is issued on the compute stream after
        the compute that last read its slot, and waits for it there."""

    def slot(self, step: int) -> Tuple[torch.Tensor, ...]:
        """The slots computed on at ``step``, once the hop that filled them
        has landed."""
        recv = self._landing[step % 2]
        if recv is not None:
            recv.finish()
            self._landing[step % 2] = None
        return tuple(buf[step % 2] for buf in self.bufs)

    def send(self, step: int, hops: int = 1, out=None) -> None:
        """Sends this rank's slot ``step % 2`` to rank r + hops *
        direction's slot ``(step + 1) % 2``, and receives rank r - hops *
        direction's into this rank's, or into ``out`` (a tensor [1, *shape]
        per payload: the direct return of a rider to its home rank)."""
        src = step % 2
        self.slot(step)             # the hop that filled the sent slot
        dst = out if out is not None else [buf[1 - src] for buf in self.bufs]
        recv = self.ring._hop([buf[src] for buf in self.bufs], dst,
                              hops * self.direction, self.tag)
        if out is None:
            self._landing[1 - src] = recv


class ProcessRing:
    """The ring of one mesh axis whose ``n`` ranks are processes: this
    process holds rank ``rank``, and its tensors carry that one rank on
    their leading axis.  ``group`` is the axis's process group, ``members``
    its global ranks by coordinate.  Counts the bytes this rank's hops send
    in ``hop_bytes``."""

    def __init__(self, n: int, rank: int, group, members: Sequence[int],
                 device):
        self.n, self.rank, self.device = n, rank, _indexed(device)
        self.held = 1
        self.group, self.members = group, tuple(members)
        self.backend = dist.get_backend(group)
        self.staged = self.device.type == "cuda" and self.backend == "gloo"
        self.hop_bytes = 0
        self._pending: list = []      # every hop not joined yet
        self._tags = 0

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def check(self, *tensors) -> None:
        for t in tensors:
            if t is not None and t.device != self.device:
                raise ValueError(f"rank {self.rank} of a ring of {self.n} "
                                 f"processes on {self.device} got a tensor "
                                 f"on {t.device}")

    def channel(self, payloads: Sequence[Tuple],
                direction: int) -> ProcessChannel:
        """As :meth:`LocalRing.channel`, for this rank's slots."""
        return ProcessChannel(self, payloads, direction)

    def permute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """This rank's ``x`` sent to rank r + shift, and rank r - shift's
        returned, as a new tensor; differentiable, the gradient going the
        other way (``lax.ppermute`` and its transpose)."""
        return _Permute.apply(x, self, shift)

    def join(self) -> None:
        """Completes every hop issued so far (sends and receives)."""
        for recv in self._pending:
            recv.finish()
        self._pending = []

    # ---- internals
    def _next_tag(self, count: int) -> int:
        """Tags of a new channel's payloads (gloo matches a receive by
        peer and tag; every rank makes its channels in the same order)."""
        tag, self._tags = self._tags, (self._tags + count) % (1 << 20)
        return tag

    def _hop(self, srcs, dsts, shift: int, tag: int) -> _Recv:
        """Sends ``srcs`` to rank r + shift and receives rank r - shift's
        into ``dsts`` (one tensor per payload); returns the receive."""
        k = shift % self.n
        for s in srcs:
            self.hop_bytes += s.numel() * s.element_size()
        if k == 0:
            for s, d in zip(srcs, dsts):
                d.copy_(s)
            return _Recv([], [])
        to = self.members[(self.rank + k) % self.n]
        frm = self.members[(self.rank - k) % self.n]
        ops, staged = [], []
        for i, (s, d) in enumerate(zip(srcs, dsts)):
            if self.staged:
                s_host = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                s_host.copy_(s)
                d_host = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
                staged.append((d_host, d))
                s, d = s_host, d_host
            elif not d.is_contiguous():
                raise ValueError("a hop receives into contiguous tensors")
            ops += [dist.P2POp(dist.isend, _wire(s.contiguous()), to,
                               self.group, tag + i),
                    dist.P2POp(dist.irecv, _wire(d), frm, self.group,
                               tag + i)]
        recv = _Recv(dist.batch_isend_irecv(ops), staged)
        self._pending.append(recv)
        return recv


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the point-to-point calls take it (bool as bytes)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, shift):
        ctx.ring, ctx.shift = ring, shift
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        ring._hop([x.detach()], [out], shift, ring._next_tag(1)).finish()
        ring.join()
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        ctx.ring._hop([g], [out], -ctx.shift,
                      ctx.ring._next_tag(1)).finish()
        ctx.ring.join()
        return out, None, None


def _indexed(device) -> torch.device:
    """``device`` with its index (cuda means the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Named axes and their sizes (``shape``), the device that holds this
    process's ranks, and the ring of the ``seq`` axis.  A mesh over
    processes also knows this rank's coordinates and the process groups of
    its axes; a mesh of one process has none."""

    def __init__(self, shape: Dict[str, int], device,
                 coords: Optional[Dict[str, int]] = None):
        self.shape = dict(shape)
        self.device = _indexed(device)
        self._rings: Dict[str, LocalRing] = {}
        self.coords = dict(coords) if coords is not None else None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], list] = {}
        if self.coords is not None:
            self._build_groups()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def across_processes(self) -> bool:
        """True when the mesh's axes span several processes."""
        return self.coords is not None and self.size > 1

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.coords is not None else 0

    def ring(self, axis: str = SEQ):
        """The ring of ``axis``: across processes when the mesh spans them
        (:class:`ProcessRing`), else held by this process
        (:class:`LocalRing`)."""
        if axis not in self._rings:
            n = self.shape[axis]
            if self.coords is not None and n > 1:
                self._rings[axis] = ProcessRing(
                    n, self.coords[axis], self.group(axis),
                    self._members[(axis,)], self.device)
            else:
                self._rings[axis] = LocalRing(n, self.device)
        return self._rings[axis]

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def coord(self, *axes: str) -> Tuple[int, int]:
        """(this rank's index, the count) along ``axes`` taken together,
        row-major in the mesh's order of the axes (which is the order of
        the ranks in :meth:`group`; a batch sharded over ``("dcn_data",
        "data")`` puts ``dcn_data`` outermost, as JAX does)."""
        index, count = 0, 1
        for a in sorted(axes, key=lambda a: list(self.shape).index(a)
                        if a in self.shape else -1):
            n = self.shape.get(a, 1)
            c = self.coords.get(a, 0) if self.coords is not None else 0
            index, count = index * n + c, count * n
        return index, count

    def batch_coord(self) -> Tuple[int, int]:
        return self.coord(*BATCH_AXES)

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes``, or None when those axes hold one rank."""
        key = tuple(a for a in self.shape if a in axes
                    and self.shape[a] > 1)
        return self._groups.get(key) if key else None

    def _build_groups(self):
        """Every rank calls ``new_group`` for every subgroup in the same
        order (the collective contract) and keeps its own."""
        names = list(self.shape)
        sizes = [self.shape[a] for a in names]
        ranks = torch.arange(self.size).reshape(sizes)
        wide = [a for a in names if self.shape[a] > 1]
        sets = [(a,) for a in wide]
        for combo in (BATCH_AXES, TP_AXES, tuple(names)):
            key = tuple(a for a in names if a in combo and a in wide)
            if len(key) > 1 and key not in sets:
                sets.append(key)
        for key in sets:
            dims = [names.index(a) for a in key]
            rest = [i for i in range(len(names)) if i not in dims]
            blocks = ranks.permute(*rest, *dims).reshape(
                -1, math.prod(sizes[i] for i in dims))
            for block in blocks.tolist():
                g = dist.new_group(block)
                if self.rank in block:
                    self._groups[key], self._members[key] = g, block

    def barrier(self) -> None:
        if self.across_processes:
            dist.barrier()


def build_mesh(mesh_shape: Tuple[int, ...] = (1, 1),
               axis_names: Tuple[str, ...] = ("data", "model"),
               device: Optional[object] = "cuda") -> Mesh:
    """A mesh of the named axes (the card unless the caller asks for the
    CPU).  Its axes over 1 span the ``torch.distributed`` world
    (``core/distributed.py`` ``initialize_distributed``), whose size must
    be their product: rank r sits at the row-major coordinates of r.  A
    ``seq`` axis alone, in a world of one process, stays in this process
    (:class:`LocalRing`).  ``seq`` composes with the batch axes and
    ``model``, ``pipe`` with the batch axes; other combinations raise."""
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {mesh_shape} and axis_names "
                         f"{axis_names} differ in length")
    for name, size in zip(axis_names, mesh_shape):
        if size < 1:
            raise ValueError(f"axis {name!r} of size {size}")
    shape = dict(zip(axis_names, mesh_shape))
    wide = [a for a, n in shape.items() if n > 1]
    _check_axes(shape, wide)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no "
                           f"CUDA card (pass device='cpu' to run on the CPU)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not wide or (wide == [SEQ] and world == 1):
        return Mesh(shape, device)
    need = math.prod(shape[a] for a in wide)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} spans {need} processes, but torch.distributed is "
            f"not initialised (core/distributed.py initialize_distributed, "
            f"or launch with torch.distributed.run)")
    if world != need:
        raise ValueError(f"mesh {shape} needs a world of {need} processes, "
                         f"not {world}")
    idx = torch.unravel_index(torch.tensor(dist.get_rank()),
                              tuple(mesh_shape))
    coords = {a: int(i) for a, i in zip(axis_names, idx)}
    return Mesh(shape, device, coords)


def _check_axes(shape: Dict[str, int], wide) -> None:
    """Refuses the combinations of axes over 1 that no step runs."""
    if SEQ in wide and "expert" in wide:
        raise ValueError(
            f"mesh {shape}: a {SEQ!r} ring beside an 'expert' axis is not "
            f"a layout the train CLI builds (it takes {SEQ!r} over "
            f"'expert'); shard the sequence or the experts")
    if PIPE in wide:
        other = [a for a in wide if a not in (PIPE,) + BATCH_AXES]
        if other:
            raise ValueError(
                f"mesh {shape}: a {PIPE!r} axis beside {other}: a pipeline "
                f"stage runs its layers whole on each rank (as the JAX "
                f"package's shard_map over {PIPE!r} does), so {PIPE!r} "
                f"composes with the batch axes {BATCH_AXES} only")


def build_hybrid_mesh(dcn_data: int = 1, ici_data: int = -1, model: int = 1,
                      device: Optional[object] = "cuda") -> Mesh:
    """Multi-slice mesh: ``("dcn_data", "data", "model")`` with
    ``dcn_data`` outermost, so only the once-per-step gradient all-reduce
    crosses slices (hosts); ``ici_data`` -1 fills the rest of the world."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if ici_data == -1:
        per_slice = n // dcn_data
        if per_slice % model:
            raise ValueError(
                f"{per_slice} per-slice ranks not divisible by model={model}")
        ici_data = per_slice // model
    return build_mesh((dcn_data, ici_data, model),
                      ("dcn_data", "data", "model"), device=device)


def local_mesh(data: int = -1, model: int = 1,
               device: Optional[object] = "cuda") -> Mesh:
    """Mesh over the whole world; ``data`` -1 fills what ``model`` does not
    use."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    return build_mesh((data, model), device=device)
