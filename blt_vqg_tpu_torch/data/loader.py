"""Host -> device input pipeline with prefetch (counterpart of
``blt_vqg_tpu/data/loader.py``).

Batches are assembled on the host in numpy exactly as the JAX package does
(:func:`_host_batches`, the same permutations for the same seed), so batch
order and contents equal the JAX loader's.  :class:`Prefetcher` then moves
each batch to the model's device from a background thread: on a CUDA
device through pinned memory with ``non_blocking=True`` on a side stream,
keeping ``depth`` batches in flight; the consumer's stream waits for a
batch's copy before using it.  Augmentation runs on the device
(``data/augment.py``).

Across processes every rank draws the same global permutation and loads
only the ``batch_size / D`` rows of its coordinate along the mesh's batch
axes (``dcn_data`` and ``data``), not of its global rank: ranks that differ
only along ``model`` or ``expert`` load the same rows.  Those rows stay the
rank's own (``core/distributed.py`` ``host_local_batch_to_global``); the
train step reduces across ranks what needs the whole batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from blt_vqg_tpu_torch.data.dataset import example_from_row


class Prefetcher:
    """Wraps a host-batch iterator and yields its batches as tensors on
    ``device``, copied ahead of use by a background thread.  ``multihost``
    is taken for the JAX signature: each rank's batch is its own rows
    already, so nothing is assembled."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], device="cuda",
                 depth: int = 2, multihost: Optional[bool] = None):
        del multihost
        from blt_vqg_tpu_torch.serve import check_device
        self._device = check_device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _put_device(self, batch: Dict[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not self._cuda:
            return {k: v.to(self._device) for k, v in host.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self._device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _offer(self, item) -> bool:
        """Queues ``item``; False once :meth:`close` was called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self, it):
        try:
            for batch in it:
                if not self._offer(self._put_device(batch)):
                    return
            self._offer(None)
        except BaseException as e:  # surface worker failures to the consumer
            self._offer(e)

    def close(self) -> None:
        """Stops the copying thread (an infinite stream's would otherwise
        wait on its full queue for the life of the process)."""
        self._stop.set()
        self._thread.join()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        batch, done = item
        if done is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(done)
            for t in batch.values():
                t.record_stream(current)
        return batch


def _host_batches(dataset, batch_size: int, input_mode: str,
                  shuffle: bool, seed: int, drop_remainder: bool,
                  epochs: Optional[int],
                  sample_weights: Optional[np.ndarray] = None,
                  process_index: int = 0, process_count: int = 1
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields batches of ``batch_size`` examples (the JAX package's
    order: a permutation per epoch from ``RandomState(seed + epoch)``, or
    weighted draws with replacement).  With ``process_count > 1`` each
    process loads its ``batch_size / process_count`` slice of every batch."""
    n = len(dataset)
    local_bs = batch_size // max(process_count, 1)
    lo = process_index * local_bs
    epoch = 0
    while epochs is None or epoch < epochs:
        if sample_weights is not None:
            # weighted sampling with replacement (the reference's
            # WeightedRandomSampler)
            p = np.asarray(sample_weights, np.float64)
            p = p / p.sum()
            order = np.random.RandomState(seed + epoch).choice(
                n, size=n, replace=True, p=p)
        else:
            order = np.arange(n)
            if shuffle:
                np.random.RandomState(seed + epoch).shuffle(order)
        stop = n - (n % batch_size) if drop_remainder else n
        for start in range(0, stop, batch_size):
            idx = order[start:start + batch_size][lo:lo + local_bs]
            raw = dataset.batch(idx)
            batch = example_from_row(raw, input_mode)
            batch["image_ids"] = raw["image_ids"]
            batch["answer_types"] = raw["answer_types"]
            yield batch
        epoch += 1


def make_loader(dataset, batch_size: int, input_mode: str = "ans",
                shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = True, epochs: Optional[int] = None,
                mesh=None, prefetch_depth: int = 2,
                device: Union[bool, str, torch.device] = True,
                sample_weights: Optional[np.ndarray] = None,
                multihost: Optional[bool] = None):
    """Infinite (``epochs=None``) or bounded stream of model-ready batches.

    ``device=False`` yields the host (numpy) batches; ``True`` (the CUDA
    card) or a device prefetches them onto that device.  ``batch_size`` is
    the global batch: on a ``mesh`` across processes (or with
    ``multihost``, which defaults to that) each rank loads the rows of its
    coordinate along the mesh's batch axes; ``multihost=True`` without
    such a mesh slices by process (``torch.distributed`` rank and world
    size), as the JAX package slices by host.  A ``seq`` mesh shards no
    batch axis, so the batch goes whole to ``device``."""
    wide = mesh is not None and mesh.across_processes
    if multihost is None:
        multihost = wide
    if not multihost:
        index, count = 0, 1
    elif wide:
        index, count = mesh.batch_coord()
    else:
        from blt_vqg_tpu_torch.core.distributed import (process_count,
                                                        process_index)
        index, count = process_index(), process_count()
    if batch_size % count:
        raise ValueError(f"global batch {batch_size} over {count} batch "
                         f"shards")
    it = _host_batches(dataset, batch_size, input_mode, shuffle, seed,
                       drop_remainder, epochs, sample_weights,
                       process_index=index, process_count=count)
    if device is False:
        return it
    return Prefetcher(it, device="cuda" if device is True else device,
                      depth=prefetch_depth)
