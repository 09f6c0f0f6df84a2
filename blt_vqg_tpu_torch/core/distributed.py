"""Process-group initialisation and each rank's share of the global batch
(counterpart of ``blt_vqg_tpu/core/distributed.py``).

One process per card.  :func:`initialize_distributed` joins the job that
``torch.distributed.run`` (or the caller) describes: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, or
explicit arguments.  The backend follows the device: NCCL for the card,
gloo for the CPU; a caller may name one (two processes that share one card
take gloo, since NCCL refuses two ranks on one GPU).  After it,
``parallel/mesh.py`` ``build_mesh`` lays the world out over the named axes.

Each rank loads only its own rows of every global batch (``data/loader.py``)
and keeps them: :func:`host_local_batch_to_global` names the global batch
the rows belong to and assembles no global tensor.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S,
                           local_rank: Optional[int] = None) -> None:
    """Joins this process to the job; a no-op for a single-process run.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  ``device`` (default the card) picks the
    backend, NCCL for a CUDA device and gloo for the CPU, unless
    ``backend`` names one.  On the card the process takes card
    ``LOCAL_RANK`` (or ``local_rank``).  ``timeout_s`` bounds the world's
    collectives, so a rank that never arrives fails the job instead of
    hanging it."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    if coordinator_address is None and world is None:
        log.info("single-process run; torch.distributed not initialised")
        return
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None or world is None:
        raise ValueError("initialize_distributed needs the world size and "
                         "this process's rank (WORLD_SIZE and RANK)")
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        coordinator_address = f"{addr}:{os.environ['MASTER_PORT']}"
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        lr = local_rank if local_rank is not None else (
            _env_int("LOCAL_RANK") or 0)
        torch.cuda.set_device(lr if device.index is None else device.index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed initialised: rank %d of %d, backend %s",
             rank, world, backend)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


class LocalBatch(NamedTuple):
    """A rank's rows of a global batch: ``rows[k]`` are the global rows
    ``start .. start + len(rows[k])`` of a batch of ``global_size``."""

    rows: Dict[str, torch.Tensor]
    start: int
    global_size: int


def host_local_batch_to_global(batch: Dict[str, torch.Tensor],
                               mesh) -> LocalBatch:
    """This rank's rows of the global batch they belong to, over the
    mesh's batch axes (``dcn_data`` and ``data``).  No global tensor is
    assembled: the train step reduces across ranks what needs the whole
    batch."""
    index, count = mesh.batch_coord()
    local = len(next(iter(batch.values())))
    return LocalBatch(dict(batch), index * local, local * count)
