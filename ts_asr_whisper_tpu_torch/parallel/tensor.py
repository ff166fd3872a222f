"""Tensor parallelism of the port: Megatron column / row sharding of every
attention and MLP projection over the ``model`` axis of the mesh, with the
collectives written out.

Counterpart of the ``tp_axis`` placement of ts_asr_whisper_tpu/parallel/
mesh.py:41-88 (``_TP_COL``, ``_TP_ROW``, ``param_shardings``). The JAX
package places the parameters by name and GSPMD inserts the collectives;
here each rank holds plain local shards, chosen by the same name rule, and
the model calls the two collectives itself:

- ``copy_to_model``: identity forward, gradient all-reduced over the
  ``model`` group backward; applied once to each distinct input of the
  column-parallel projections (q/k/v, fc1);
- ``reduce_from_model``: all-reduce forward, identity backward; the sum of
  the row-parallel projections' partial products (out_proj, fc2), before
  their (whole) bias is added once;
- ``sync_whole_grads``: once a micro-batch, the gradients of the whole
  (replicated) tensors made the same on every model rank.

A rank at model coordinate m of ``tp`` holds output rows [m n/tp, (m+1)
n/tp) of each column-sharded weight and bias (torch's (out, in) layout, dim
0) and the same input columns of each row-sharded weight (dim 1), hence
whole heads: H / tp of them in every attention. Everything else is whole on
every rank. Without a group (tp = 1) every function here is the identity
and runs no collective.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# JAX _TP_COL / _TP_ROW by (module, parameter) under torch's names: q/k/v
# and fc1 column-sharded (k_proj has no bias), out_proj and fc2 row-sharded
# (their biases whole); under any scope, the decoder's, the SCBs'
# (``cae.cross_attn``) and the CTC head's included
_COL = {("q_proj", "weight"), ("k_proj", "weight"), ("v_proj", "weight"),
        ("fc1", "weight"), ("q_proj", "bias"), ("v_proj", "bias"),
        ("fc1", "bias")}
_ROW = {("out_proj", "weight"), ("fc2", "weight")}

# bytes of every TP all-reduce, for measurement: forward (the row-parallel
# sums), backward (the gradients of the column-parallel inputs) and
# whole_grads (``sync_whole_grads``, once a micro-batch)
reduced_bytes = {"forward": 0, "backward": 0, "whole_grads": 0}
# set by parallel/mesh.py::local_collectives for a memory probe: the
# forward's and backward's all-reduces keep their buffers and skip the
# collective. A module global, not a thread-local: on the card autograd
# runs the backward on a thread of its own
local_only = {"on": False}


def tp_dim(name: str) -> Optional[int]:
    """The dim of the parameter ``name`` (a ``named_parameters`` /
    ``state_dict`` name) that the ``model`` axis splits: 0 (column), 1
    (row) or None (whole)."""
    parts = name.rsplit(".", 2)
    key = tuple(parts[-2:])
    return 0 if key in _COL else 1 if key in _ROW else None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in a new buffer; this rank's own
    ``x`` in it, uncounted, under ``local_only``."""
    x = x.contiguous().clone()
    if local_only["on"]:
        return x
    reduced_bytes[kind] += x.numel() * x.element_size()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, "backward"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``group`` in the backward."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes unchanged."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group)


class _PartialProduct(torch.autograd.Function):
    """x @ W^T of half-precision operands, returned in fp32 (cuBLAS
    accumulates in fp32 and writes the sum unrounded); the backward rounds
    the incoming gradient to the operands' dtype, as ``F.linear``'s own
    backward receives it, so dx and dW are those of the unsharded layer's
    rows."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.device.type == "cuda":
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:  # the same products and fp32 sums on the CPU
            y = x2.float() @ w.float().t()
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w
        dw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return dx, dw


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], group) -> torch.Tensor:
    """A row-sharded linear on its input columns ``x`` (compute dtype):
    the partial products, summed over ``group`` in fp32, then the whole
    bias added once, rounded to the compute dtype at the end as an
    unsharded ``F.linear`` rounds its fp32 accumulator."""
    if x.dtype in (torch.bfloat16, torch.float16):
        y = reduce_from_model(_PartialProduct.apply(x, weight), group)
    else:
        y = reduce_from_model(F.linear(x, weight), group)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def sync_whole_grads(grads: List[torch.Tensor], partial: List[bool],
                     group) -> None:
    """One all-reduce over ``group``, in place, of the gradients of the
    tensors that every model rank holds whole: those flagged ``partial``
    (a rank's share, the LoRA adapters') summed, the others averaged. The
    others are computed alike on every rank, but on the card through
    kernels that add in run-to-run order (the CTC loss's, the convolutions'
    backward), so without this the peers' copies would drift apart by an
    update in the last bits at a time."""
    if not grads:
        return
    tp = group_size(group)
    flat = torch.cat([(g if part else g / tp).float().reshape(-1)
                      for g, part in zip(grads, partial)])
    reduced_bytes["whole_grads"] += flat.numel() * flat.element_size()
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def shard_state_dict(full: Dict[str, torch.Tensor], m: int, tp: int
                     ) -> Dict[str, torch.Tensor]:
    """Model coordinate ``m``'s local tensors of a whole state dict (the
    weights function: a JAX tree goes through ``state_dict_from_jax``
    first). Views of ``full``; the identity at tp = 1."""
    if tp == 1:
        return dict(full)
    out = {}
    for name, t in full.items():
        dim = tp_dim(name)
        if dim is None:
            out[name] = t
            continue
        if t.shape[dim] % tp:
            raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not "
                             f"divide over {tp} model ranks")
        n = t.shape[dim] // tp
        out[name] = t.narrow(dim, m * n, n)
    return out


def gather_state_dict(local: Dict[str, torch.Tensor], group
                      ) -> Dict[str, torch.Tensor]:
    """The whole tensors of a local state dict: each TP-sharded tensor
    gathered along its dim over ``group`` (a collective every rank of it
    calls), the others as they are."""
    tp = group_size(group)
    if tp == 1:
        return dict(local)
    out = {}
    for name, t in local.items():
        dim = tp_dim(name)
        if dim is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(tp)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[name] = torch.cat(parts, dim=dim)
    return out


def model_group(model: nn.Module):
    """The ``model`` group over which ``model`` is tensor-sharded, or None
    (``shard_model_`` sets it on each attention and layer)."""
    for m in model.modules():
        if hasattr(m, "tp_group"):
            return m.tp_group
    return None


@torch.no_grad()
def shard_model_(model: nn.Module, group) -> nn.Module:
    """Slice every parameter of a whole model by ``tp_dim`` in place (this
    rank's coordinate in ``group``), give each attention its local head
    count and each attention and layer the group. The identity at tp = 1.
    LoRA adapters stay whole: each column-sharded linear records its rows
    (``tp_rows``), of which its share of B A is taken
    (training/lora.py)."""
    tp, m = group_size(group), group_rank(group)
    if tp == 1 or model_group(model) is not None:  # whole, or sliced before
        return model
    from ..models.whisper import Attention, EncoderLayer

    params = dict(model.named_parameters())
    local = shard_state_dict({n: p.data for n, p in params.items()}, m, tp)
    for name, p in params.items():
        if tp_dim(name) is not None:
            p.data = local[name].clone()
    for mod in model.modules():
        if isinstance(mod, Attention):
            if mod.num_heads % tp:
                raise ValueError(f"{mod.num_heads} heads over {tp} model "
                                 "ranks: the port keeps whole heads")
            mod.num_heads //= tp
            for lin in (mod.q_proj, mod.k_proj, mod.v_proj):
                lin.tp_rows = (m * lin.weight.shape[0],
                               (m + 1) * lin.weight.shape[0])
        if isinstance(mod, (Attention, EncoderLayer)):
            mod.tp_group = group
    return model


def model_peer_batches(batches: Iterable, group, build: bool
                       ) -> Iterator:
    """The batches of one model group: the rank that ``build``s (model
    coordinate 0) draws them from ``batches`` and broadcasts each over
    ``group``, the others receive them, so every model peer computes on the
    same rows (the collator's augmentations draw from unseeded global
    generators); one batch at a time, as the trainer asks, and a None at
    the end; closing the generator closes the source. ``batches`` itself
    at tp = 1."""
    if group_size(group) == 1:
        yield from batches
        return
    src = dist.get_global_rank(group, 0)
    it = iter(batches) if build else None
    try:
        while True:
            box = [next(it, None) if build else None]
            dist.broadcast_object_list(box, src=src, group=group)
            if box[0] is None:
                return
            yield box[0]
    finally:
        # closed early (auto_find_batch_size halving): the source's
        # workers stop now, not when the generator is collected
        if hasattr(it, "close"):
            it.close()
