"""Process helpers of the port over ``torch.distributed``.

Counterpart of ts_asr_whisper_tpu/parallel/dist.py:31-109, the same names
and semantics:

- ``torchrun`` starts one process (rank) per device; ``initialize`` joins
  them from its ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` (a no-op without them, as the JAX one is without
  ``JAX_COORDINATOR_ADDRESS``);
- training runs DDP or FSDP2 over the ranks (parallel/mesh.py), each rank
  feeding its local rows of every global batch (training/dataloader.py);
- long-form eval shards the dataset's batches round-robin over the ranks,
  gathers the predictions (``gather_from_processes``), scores on rank 0 and
  broadcasts the metrics (``broadcast_from_main``).

Objects travel pickled through ``broadcast_object_list`` /
``all_gather_object``. The default backend puts CPU tensors (and so the
objects and the barrier) on gloo and CUDA tensors on NCCL; a backend that
fails to start is an error, never replaced by another.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

DEFAULT_BACKEND = "cpu:gloo,cuda:nccl"


def initialize(backend: str = DEFAULT_BACKEND,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """``init_process_group`` from the arguments or torchrun's environment
    (``env://``); a no-op for a single-process run, or when the group
    already exists."""
    if dist.is_initialized():
        return
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def finalize() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_zero_rank() -> bool:
    return get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", get_rank()))


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others (a CPU all-reduce, so it stays
    off the card's backend)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1))


def broadcast_from_main(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank; the other ranks' ``obj`` is ignored
    (they may pass None)."""
    if world_size() <= 1:
        return obj
    box = [obj if is_zero_rank() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_from_processes(obj: Any) -> List[Any]:
    """One picklable object per rank, as a list indexed by rank, on every
    rank."""
    if world_size() <= 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def shard_indices_by_process(n: int) -> List[int]:
    """Round-robin item shard for this process (the DDP eval sampler:
    item i belongs to rank i % world). Every process gets ceil-ish equal
    work; duplicate-free, union covers [0, n)."""
    return list(range(get_rank(), n, world_size()))
