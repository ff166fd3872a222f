"""Device mesh and model wrappers of the port: data parallelism, and
tensor parallelism over a ``model`` axis, over the ranks that torchrun
starts, one rank per device.

Counterpart of ts_asr_whisper_tpu/parallel/mesh.py:24-108:

- ``make_mesh`` is ``init_device_mesh`` over ``("data",)`` or ``("data",
  "model")``, row-major as JAX's ``devices.reshape(shape)`` (the rank at
  (d, m) is d * tp + m); None without a process group (a plain
  single-process run; torchrun with one rank gets a mesh of one); a shape
  that needs more ranks than the world has raises ``ValueError`` as the
  JAX one does, one that leaves ranks out raises too;
- the ``model`` axis is tensor parallelism (parallel/tensor.py: the
  parameters sliced by name, explicit collectives); ``full_state_dict`` /
  ``load_full_state_dict`` gather and slice over it;
- ``wrap_model`` turns ``param_shardings``' choice over ``data`` into a
  wrapper of the (already TP-sliced) local tensors: replicated parameters
  are DDP over the ``data`` group (the gradient all-reduce XLA inserts),
  with the gradients as views of its buckets, so they take no second copy;
  ``shard_params`` is FSDP2 (``fully_shard``) over the ``data`` axis, the
  ZeRO-style sharding of parameters, gradients and optimizer state;
- ``shard_batch`` has no counterpart: the DataLoader gives each data
  coordinate its local rows of every global batch
  (training/dataloader.py:87-88), and ``model_peer_batches``
  (parallel/tensor.py) hands them to the model group;
- ``local_collectives`` has no counterpart: the memory probe of
  ``auto_find_batch_size`` (train.py) runs the wrapped forward and
  backward with every collective inside replaced by an allocation of the
  same size, so that no rank waits on another until the probe's outcome
  is all-reduced (the JAX retry wraps the whole SPMD step instead).

FSDP2 units: every encoder and decoder layer (with its LoRA adapters),
the encoder and the whole model. FSDP2 all-gathers one dtype per unit, so a
decoder layer whose adapters (fp32) and weights (a bf16 ``param_dtype``)
differ is refused. The encoder runs its layers through ``attn_in`` /
``attn_out`` under the ``'attn'`` remat policy, and the trainer calls
``encoder.ctc_logits`` outside the model's ``forward``, so those methods
are registered as forward methods: each unshards its unit's parameters as
a ``forward`` does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel as DDP

from . import dist as pdist
from . import tensor as ptensor
from .tensor import gather_state_dict, group_rank, model_group, \
    shard_state_dict

DATA_AXIS, MODEL_AXIS = "data", "model"
AXES = ((DATA_AXIS,), (DATA_AXIS, MODEL_AXIS))


def check_mesh(shape: Optional[Sequence[int]], axis_names: Sequence[str],
               world: int) -> Tuple[int, ...]:
    """The mesh shape (None -> (world,)), checked against what the port
    runs: a ``data`` axis, or ``data`` x ``model``, over every rank."""
    shape = tuple(shape) if shape else (world,)
    names = tuple(axis_names)
    if names not in AXES or len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} over axes {names}: the port "
                         f"runs the axes {AXES[0]} or {AXES[1]}")
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
    """The mesh over every rank, or None without a process group."""
    shape = check_mesh(shape, axis_names, pdist.world_size())
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The ranks along ``axis`` (1 without a mesh or without the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without it)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's peers along ``axis``; None without
    the axis, and for the ``model`` axis of size 1 (nothing to sum)."""
    if mesh is None or axis not in mesh.mesh_dim_names or (
            axis == MODEL_AXIS and axis_size(mesh, axis) == 1):
        return None
    return mesh.get_group(axis)


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def unwrap(model: nn.Module) -> nn.Module:
    """The model a DDP wrapper holds (FSDP2 shards the model in place)."""
    return model.module if isinstance(model, DDP) else model


def wrap_model(model: nn.Module, mesh, shard_params: bool,
               init_sync: bool = True) -> nn.Module:
    """The module the training step calls: ``model`` itself without a mesh;
    FSDP2 over the mesh's ``data`` axis with ``shard_params`` (``model`` is
    sharded in place and returned); else DDP over the ``data`` group and
    the parameters that need a gradient now (rebuild it when that set
    changes). ``init_sync`` broadcasts the data group's first rank's
    parameters first (DDP). Tensor-parallel parameters are sliced before
    (``shard_model_``); data peers hold the same slices."""
    if mesh is None:
        return model
    data = mesh[DATA_AXIS]
    if shard_params:
        from torch.distributed.fsdp import (fully_shard,
                                            register_fsdp_forward_method)

        if is_sharded(model):
            return model
        encoder, decoder = model.encoder, model.decoder
        dtypes = {p.dtype for p in decoder.layers.parameters()}
        if len(dtypes) > 1:
            raise NotImplementedError(
                f"training.shard_params over decoder layers of {len(dtypes)}"
                f" dtypes {sorted(map(str, dtypes))}: FSDP2 all-gathers one "
                "dtype per unit, and the LoRA adapters stay fp32 (as the JAX "
                "package's lora tree); set model.param_dtype=float32")
        for layer in encoder.layers:
            fully_shard(layer, mesh=data)
            register_fsdp_forward_method(layer, "attn_in")
            register_fsdp_forward_method(layer, "attn_out")
        for layer in decoder.layers:
            fully_shard(layer, mesh=data)
        fully_shard(encoder, mesh=data)
        register_fsdp_forward_method(encoder, "ctc_logits")
        fully_shard(model, mesh=data)
        return model
    device = next(model.parameters()).device
    return DDP(model, device_ids=[device] if device.type == "cuda" else None,
               process_group=data.get_group(), broadcast_buffers=False,
               gradient_as_bucket_view=True, init_sync=init_sync)


def release(wrapped: nn.Module) -> None:
    """Detach a DDP wrapper's gradient hooks from its parameters before
    another wrapper takes them."""
    if isinstance(wrapped, DDP):
        wrapped._remove_autograd_hooks()


class _LocalAllGather:
    """FSDP2's all-gather comm without the collective: the buffer as its
    default comm allocates it, every slot filled with this rank's own shard
    (finite, deterministic values of the whole parameter's size)."""

    def allocate(self, size, *, dtype, device) -> torch.Tensor:
        return torch.empty(*size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, async_op=False):
        # the input is this rank's slot of the output (FSDP2's copy-in)
        slots = output_tensor.view(group.size(), -1)
        for r in range(group.size()):
            if r != group.rank():
                slots[r].copy_(input_tensor.view(-1))
        return None


class _LocalReduceScatter:
    """FSDP2's reduce-scatter comm without the collective: the buffers as
    its default comm allocates them, the output this rank's slice of the
    input."""

    def allocate(self, size, *, dtype, device) -> torch.Tensor:
        return torch.empty(*size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, op=None,
                 async_op=False):
        output_tensor.copy_(input_tensor.view(group.size(), -1)[group.rank()])
        return None


def _fsdp_param_groups(unit) -> list:
    """The FSDP2 parameter groups of one ``fully_shard`` unit: a list in
    torch 2.13 (per-parameter meshes), one group or None in torch 2.11."""
    state = unit._get_fsdp_state()
    groups = getattr(state, "_fsdp_param_groups", None)
    if groups is None:
        group = getattr(state, "_fsdp_param_group", None)
        groups = [] if group is None else [group]
    return list(groups)


@contextlib.contextmanager
def local_collectives(model: nn.Module) -> Iterator[None]:
    """Within it, the forward and backward of ``model`` run no collective
    and allocate what they would with them: every FSDP2 unit all-gathers
    and reduce-scatters through ``_LocalAllGather`` / ``_LocalReduceScatter``
    (``set_custom_all_gather`` / ``set_custom_reduce_scatter``), and the
    tensor-parallel all-reduces keep their buffers and skip the collective
    (``tensor.local_only``). The comms that FSDP2 held are put back on exit.
    The gradient sync stays on, so FSDP2 frees each unsharded gradient
    after its reduce-scatter as in a training step (``set_requires_
    gradient_sync(False)`` would keep them). DDP's bucket all-reduce is not
    replaced: a probe under DDP runs in ``no_sync``."""
    from torch.distributed.fsdp import FSDPModule

    units = [m for m in model.modules() if isinstance(m, FSDPModule)]
    held = [(u, [(g._all_gather_comm, g._reduce_scatter_comm)
                 for g in _fsdp_param_groups(u)]) for u in units]
    try:
        for u in units:
            u.set_custom_all_gather(_LocalAllGather())
            u.set_custom_reduce_scatter(_LocalReduceScatter())
        ptensor.local_only["on"] = True
        yield
    finally:
        ptensor.local_only["on"] = False
        for u, comms in held:
            for g, (all_gather, reduce_scatter) in zip(
                    _fsdp_param_groups(u), comms):
                g._all_gather_comm = all_gather
                g._reduce_scatter_comm = reduce_scatter


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


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of an FSDP2 parameter (a DTensor split on dim 0 over
    a 1-D mesh as ``torch.chunk`` splits it): each rank's shard padded to
    the chunk size and gathered by ``all_gather_into_tensor``, the c10d
    collective of FSDP2's own unsharding (``DTensor.full_tensor``'s
    functional collective crashes over gloo with CUDA tensors, torch
    2.11); any other tensor as it is. A collective every rank calls."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    assert tuple(t.placements) == (Shard(0),), t.placements
    group = t.device_mesh.get_group()
    world, n = dist.get_world_size(group), t.shape[0]
    chunk = -(-n // world)
    local = t.to_local()
    padded = local.new_zeros((chunk, *t.shape[1:]))
    padded[:local.shape[0]] = local
    out = local.new_empty((chunk * world, *t.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:n]


def full_state_dict(model: nn.Module, to_cpu: bool = True) -> dict:
    """The unwrapped model's state dict with whole tensors, gathered over
    the ``model`` group and unsharded from FSDP2: a collective that every
    rank calls. With ``to_cpu``, under FSDP2 or tensor parallelism only
    rank 0 receives the tensors, on the host (the others get {}), else
    every rank does."""
    group = model_group(model)
    if not is_sharded(model):
        state = unwrap(model).state_dict()
        if group is None:
            return state
    else:
        state = {k: _whole(v) for k, v in model.state_dict().items()}
    if group is not None:
        state = gather_state_dict(state, group)
    if not to_cpu:
        return state
    return ({k: v.detach().cpu() for k, v in state.items()}
            if pdist.is_zero_rank() else {})


def load_full_state_dict(model: nn.Module, state: dict) -> None:
    """Load whole tensors into a model, sliced over the ``model`` group and
    sharded under FSDP2 (every rank passes the full state)."""
    group = model_group(model)
    if group is not None:
        state = shard_state_dict(state, group_rank(group),
                                 dist.get_world_size(group))
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


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The element-wise maximum of ``t`` over the ranks of ``group``, in
    place."""
    if pdist.world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t
