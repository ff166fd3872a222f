"""Top-k of the port with ``jax.lax.top_k``'s tie rule.

Counterpart of ts_asr_whisper_tpu/ops/topk.py. ``lax.top_k`` returns equal
values lower index first; ``torch.topk`` does not promise an order among
ties (on CUDA it has none), and at the first beam step beams 1..n-1 carry
the same -1e9 score, so beam search meets massive exact ties. Two impls,
both with the JAX rule exactly:

- 'lax' (the default): a stable descending sort of the whole row;
- 'thresholded': the k-th largest value from the monotone integer keys of
  the floats (ops/ctc_prefix.py::kth_largest_keys), the members above it
  and the first ties at it in index order, compacted by a cumsum scatter,
  then a stable sort of the k survivors (topk.py:54-82).

``topk_large`` (beam search's candidate top-k over (B, n * V) rows) follows
the switch ``set_topk_impl``; the other top-k calls of the port are
``topk_lax``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .ctc_prefix import kth_largest_keys

TOPK_IMPLS = ("lax", "thresholded")
_IMPL = "lax"


def set_topk_impl(impl: str) -> None:
    """Select the beam candidate top-k impl (topk.py:28-41); 'thresholded'
    gives the same values and indices."""
    global _IMPL
    if impl not in TOPK_IMPLS:
        raise ValueError(f"topk impl {impl!r}: want one of {TOPK_IMPLS}")
    _IMPL = impl


def get_topk_impl() -> str:
    return _IMPL


def topk_lax(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of a 2-D
    tensor, in descending order, ties lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_large(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of huge rows under the configured impl."""
    if _IMPL == "thresholded":
        return topk_thresholded(x, k)
    return topk_lax(x, k)


def topk_thresholded(x: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_lax`` of a 2-D float tensor (cast to fp32) without sorting the
    row: exactly k members (every key above the k-th largest, then the
    first ties at it in index order), their indices compacted in index
    order, and a stable sort of the k survivors."""
    b, v = x.shape
    x = x.float()
    keys, kth = kth_largest_keys(x, k)
    greater = keys > kth[:, None]
    ties = keys == kth[:, None]
    m_needed = (k - greater.sum(dim=1))[:, None]
    tie_rank = torch.cumsum(ties.to(torch.int32), dim=1)
    member = greater | (ties & (tie_rank <= m_needed))      # exactly k set
    # member j's slot is its rank in index order; the others land in the
    # spare slot k, which is dropped
    slot = torch.where(member, torch.cumsum(member.to(torch.int32), dim=1)
                       - 1, k).long()
    cols = torch.arange(v, device=x.device).expand(b, v)
    idx = torch.zeros((b, k + 1), dtype=torch.long, device=x.device) \
        .scatter_(1, slot, cols)[:, :k]
    vals, order = torch.sort(x.gather(1, idx), dim=1, descending=True,
                             stable=True)
    return vals, idx.gather(1, order)
