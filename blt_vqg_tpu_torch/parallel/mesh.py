"""The device mesh of the port (counterpart of ``blt_vqg_tpu/parallel/mesh.py``)
and the transport of its ``seq`` ring.

:func:`build_mesh` returns a :class:`Mesh` whose ``shape`` is an ``{axis:
size}`` mapping, as a ``jax.sharding.Mesh``'s is, so the attention gate can
read ``mesh.shape.get("seq", 1)``.  In this port only the ``seq`` axis may
be larger than 1: its n ranks are shards held on one device by one
process, and :class:`LocalRing` moves their blocks around the ring.  Data,
tensor and pipeline parallelism across cards, and a transport between
cards (``torch.distributed`` with NCCL ``isend``/``irecv``), are not ported
yet (ROADMAP.md queue 1, item 6).

:class:`LocalRing` keeps the protocol of the TPU ring kernels
(ops/pallas/ring_attention.py): each :class:`Channel` is a double-buffered
pair of slots per rank, and a hop is a real copy of every rank's current
slot into the next rank's other slot.  On CUDA the copies run on a side
stream and are ordered by CUDA events, which play the TPU's semaphores: a
step's compute waits for the hop that filled its slot (the receive
semaphore), and a hop waits for the compute that last read its destination
slot (the credit).  On the CPU the copies are synchronous.  Every buffer a
hop touches is allocated on the compute stream before the first hop, and
:meth:`LocalRing.join` makes the compute stream wait for the side stream
before any of them is released, so the caching allocator never hands a
buffer back while a copy may still use it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch

SEQ = "seq"


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
    """The ring of one mesh axis: ``n`` ranks on one ``device``.  Counts
    the bytes its hops move in ``hop_bytes``."""

    def __init__(self, n: int, device):
        self.n, self.device = n, _indexed(device)
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


def _indexed(device) -> torch.device:
    """``device`` with its index (cuda means the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Named axes and their sizes (``shape``), the device that holds every
    rank, and the ring of the ``seq`` axis."""

    def __init__(self, shape: Dict[str, int], device):
        self.shape = dict(shape)
        self.device = _indexed(device)
        self._rings: Dict[str, LocalRing] = {}

    def ring(self, axis: str = SEQ) -> LocalRing:
        if axis not in self._rings:
            self._rings[axis] = LocalRing(self.shape[axis], self.device)
        return self._rings[axis]


def build_mesh(mesh_shape: Tuple[int, ...] = (1, 1),
               axis_names: Tuple[str, ...] = ("data", "model"),
               device: Optional[object] = "cuda") -> Mesh:
    """A mesh of the named axes on one device (the card unless the caller
    asks for the CPU).  Any axis but ``seq`` above size 1 raises: it needs
    several cards and a transport between them (ROADMAP.md queue 1, item
    6)."""
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {mesh_shape} and axis_names "
                         f"{axis_names} differ in length")
    for name, size in zip(axis_names, mesh_shape):
        if size < 1:
            raise ValueError(f"axis {name!r} of size {size}")
        if size > 1 and name != SEQ:
            raise NotImplementedError(
                f"mesh axis {name!r} of size {size}: only the {SEQ!r} ring "
                f"is ported, on one device (ROADMAP.md queue 1, item 6)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no "
                           f"CUDA card (pass device='cpu' to run on the CPU)")
    return Mesh(dict(zip(axis_names, mesh_shape)), device)
