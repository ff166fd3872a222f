"""Device mesh and model wrappers of the port: data parallelism over the
ranks that torchrun starts, one rank per device.

Counterpart of ts_asr_whisper_tpu/parallel/mesh.py:24-108:

- ``make_mesh`` is ``init_device_mesh`` over a 1-D ``data`` axis that
  spans the world (None without a process group: a plain single-process
  run; torchrun with one rank gets a mesh of one); a shape that needs more
  ranks than the world has raises ``ValueError`` as the JAX one does, one
  that leaves ranks out raises too, and a ``model`` axis (tensor
  parallelism, JAX mesh.py:41-88) raises ``NotImplementedError``;
- ``wrap_model`` turns ``param_shardings``' choice into a wrapper:
  replicated parameters are DDP (the gradient all-reduce XLA inserts), with
  the gradients as views of its buckets, so they take no second copy;
  ``shard_params`` is FSDP2 (``fully_shard``) over the ``data`` axis, the
  ZeRO-style sharding of parameters, gradients and optimizer state;
- ``shard_batch`` has no counterpart: the DataLoader gives each rank its
  local rows of every global batch (training/dataloader.py:87-88).

FSDP2 units: every encoder and decoder layer, the encoder and the whole
model. The encoder runs its layers through ``attn_in`` / ``attn_out`` under
the ``'attn'`` remat policy, and the trainer calls ``encoder.ctc_logits``
outside the model's ``forward``, so those methods are registered as forward
methods: each unshards its unit's parameters as a ``forward`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel as DDP

from . import dist as pdist

DATA_AXIS = "data"


def check_mesh(shape: Optional[Sequence[int]], axis_names: Sequence[str],
               world: int) -> Tuple[int, ...]:
    """The mesh shape (None -> (world,)), checked against what the port
    runs: one ``data`` axis over every rank."""
    shape = tuple(shape) if shape else (world,)
    names = tuple(axis_names)
    if "model" in names:
        raise NotImplementedError(
            f"mesh axes {names}: a 'model' axis (tensor parallelism) is not "
            "ported yet; it is the next slice of the port")
    if names != (DATA_AXIS,) or len(shape) != 1:
        raise ValueError(f"mesh shape {shape} over axes {names}: the port "
                         f"runs one '{DATA_AXIS}' axis")
    needed = math.prod(shape)
    if needed > world:
        raise ValueError(f"mesh shape {shape} needs {needed} devices, "
                         f"have {world}")
    if needed < world:
        raise ValueError(f"mesh shape {shape} covers {needed} of the "
                         f"{world} ranks: the port runs one rank per device "
                         "of the mesh")
    return shape


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              device_type: str = "cuda"):
    """The ``data`` mesh over every rank, or None without a process
    group."""
    shape = check_mesh(shape, axis_names, pdist.world_size())
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=(DATA_AXIS,))


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def unwrap(model: nn.Module) -> nn.Module:
    """The model a DDP wrapper holds (FSDP2 shards the model in place)."""
    return model.module if isinstance(model, DDP) else model


def wrap_model(model: nn.Module, mesh, shard_params: bool,
               init_sync: bool = True) -> nn.Module:
    """The module the training step calls: ``model`` itself without a mesh;
    FSDP2 over the mesh with ``shard_params`` (``model`` is sharded in
    place and returned); else DDP over the parameters that need a gradient
    now (rebuild it when that set changes). ``init_sync`` broadcasts rank
    0's parameters first (DDP)."""
    if mesh is None:
        return model
    if shard_params:
        from torch.distributed.fsdp import (fully_shard,
                                            register_fsdp_forward_method)

        if is_sharded(model):
            return model
        encoder, decoder = model.encoder, model.decoder
        for layer in encoder.layers:
            fully_shard(layer, mesh=mesh)
            register_fsdp_forward_method(layer, "attn_in")
            register_fsdp_forward_method(layer, "attn_out")
        for layer in decoder.layers:
            fully_shard(layer, mesh=mesh)
        fully_shard(encoder, mesh=mesh)
        register_fsdp_forward_method(encoder, "ctc_logits")
        fully_shard(model, mesh=mesh)
        return model
    device = next(model.parameters()).device
    return DDP(model, device_ids=[device] if device.type == "cuda" else None,
               process_group=mesh.get_group(), broadcast_buffers=False,
               gradient_as_bucket_view=True, init_sync=init_sync)


def release(wrapped: nn.Module) -> None:
    """Detach a DDP wrapper's gradient hooks from its parameters before
    another wrapper takes them."""
    if isinstance(wrapped, DDP):
        wrapped._remove_autograd_hooks()


def shard_group(model: nn.Module):
    """The process group over which ``model``'s parameters are sharded, or
    None when each rank holds them whole."""
    if not is_sharded(model):
        return None
    return next(model.parameters()).device_mesh.get_group()


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a sharded (DTensor) parameter or gradient, as a
    plain tensor on the same storage; any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def full_state_dict(model: nn.Module, to_cpu: bool = True) -> dict:
    """The unwrapped model's state dict with whole tensors. Under FSDP2 a
    collective that every rank calls; with ``to_cpu`` only rank 0 receives
    the tensors (the others get {}), else every rank does."""
    if not is_sharded(model):
        return unwrap(model).state_dict()
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         get_model_state_dict)

    return get_model_state_dict(model, options=StateDictOptions(
        full_state_dict=True, cpu_offload=to_cpu))


def load_full_state_dict(model: nn.Module, state: dict) -> None:
    """Load whole tensors into a model, sharding them under FSDP2 (every
    rank passes the full state)."""
    if not is_sharded(model):
        unwrap(model).load_state_dict(state)
        return
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         set_model_state_dict)

    set_model_state_dict(model, state, options=StateDictOptions(
        full_state_dict=True))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place (nothing to add in a
    world of one)."""
    if pdist.world_size() > 1:
        dist.all_reduce(t, group=group)
    return t
