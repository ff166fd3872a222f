"""LoRA fine-tuning of the port: low-rank adapters on the decoder's
``q_proj`` / ``v_proj`` (its self- and cross-attention alike), merged into
the dense weights once per use and for good before the export.

Counterpart of ts_asr_whisper_tpu/training/lora.py (``init_lora``,
``merge_lora``). The JAX package keeps the adapters as a parallel ``lora``
tree and merges it inside the jitted loss. Here each targeted ``nn.Linear``
carries them as parameters of its own, ``lora_A`` (r, in) and ``lora_B``
(out, r) in the peft layout (the JAX tree's A (in, r) and B (r, out),
transposed). An adapted projection merges W + scale * B A inside its own
call (``adapted_weight``, read by models/whisper.py::linear), once per
layer forward and again in a checkpointed layer's recompute; a decode runs
inside ``merged``, on weights merged in place once. A ~ N(0, 1 / r^2)
(JAX: normal / r), drawn from a seeded ``torch.Generator`` (the numbers
differ from ``jax.random``'s; ``models/convert.py::
lora_state_dict_from_jax`` carries a JAX tree across), and B = 0, so a
fresh adapter changes nothing.

Under tensor parallelism the adapted q / v projections are column-sharded
and the adapters stay whole on every rank (the JAX ``lora`` leaves are
replicated and GSPMD shards the merge): a rank adds the rows of
scale * B A that its shard of W holds (``tp_rows``, set by
parallel/tensor.py::shard_model_), so A and B receive partial gradients,
which the trainer sums over the ``model`` group.

Under FSDP2 the adapters are parameters of their decoder layer's
``fully_shard`` unit: the merge runs where the unit's parameters are whole
(all-gathered for the layer's forward), and their gradients are reduce-
scattered with the layer's."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Tuple

import torch
from torch import nn

ALPHA, RANK = 16.0, 8
TARGETS = ("q_proj", "v_proj")


def lora_linears(model: nn.Module) -> Iterator[Tuple[str, nn.Linear]]:
    """(name, linear) of every linear that carries adapters."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear) and "lora_A" in m._parameters:
            yield name, m


@torch.no_grad()
def init_lora(model: nn.Module, generator: torch.Generator,
              rank: int = RANK) -> nn.Module:
    """Add fp32 adapters of ``rank`` to every linear named in ``TARGETS``
    under ``model.decoder``, in module order; scale ALPHA / rank."""
    for name, m in model.decoder.named_modules():
        if isinstance(m, nn.Linear) and name.rsplit(".", 1)[-1] in TARGETS:
            dev = m.weight.device
            a = torch.randn(rank, m.in_features, device=dev,
                            generator=generator) * (1.0 / rank)
            m.lora_A = nn.Parameter(a)
            m.lora_B = nn.Parameter(torch.zeros(m.out_features, rank,
                                                device=dev))
            m.lora_scale = ALPHA / rank
    return model


def _delta(m: nn.Linear) -> torch.Tensor:
    """scale * B A, fp32: the rows of this rank's shard of W."""
    b = m.lora_B
    rows = getattr(m, "tp_rows", None)
    if rows is not None:
        b = b[rows[0]:rows[1]]
    return (b.float() @ m.lora_A.float()) * m.lora_scale


def adapted_weight(m: nn.Linear) -> torch.Tensor:
    """``m``'s weight, or W + (scale * B A in fp32) cast to W's dtype when
    ``m`` carries adapters: in the graph, so gradients reach W, A and B."""
    if "lora_A" not in m._parameters:
        return m.weight
    return m.weight + _delta(m).to(m.weight.dtype)


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold each adapter into its dense weight, W + (scale * B A) cast to
    W's dtype (JAX ``merge_lora``: kernel + delta.astype(kernel.dtype)),
    and remove the adapters: the state dict is then the plain model's."""
    for _, m in list(lora_linears(model)):
        m.weight.copy_(m.weight + _delta(m).to(m.weight.dtype))
        del m.lora_A, m.lora_B, m.lora_scale
    return model


@contextmanager
def merged(model: nn.Module) -> Iterator[nn.Module]:
    """Within the block the model is ``merge_lora``'s (a decode reads the
    merged weights and adds no product per step); after it, each adapted
    linear has its exact dense weight and its adapters back."""
    held = [(m, m.weight.detach().clone(), m.lora_A, m.lora_B, m.lora_scale)
            for _, m in lora_linears(model)]
    merge_lora(model)
    try:
        yield model
    finally:
        with torch.no_grad():
            for m, w, a, b, scale in held:
                m.weight.copy_(w)
                m.lora_A, m.lora_B, m.lora_scale = a, b, scale
