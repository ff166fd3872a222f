"""Top-k of the port with ``jax.lax.top_k``'s tie rule.

Counterpart of ts_asr_whisper_tpu/ops/topk.py::topk_large under its default
('lax') rule. ``lax.top_k`` returns equal values lower index first;
``torch.topk`` does not promise an order among ties (on CUDA it has none),
and at the first beam step beams 1..n-1 carry the same -1e9 score, so beam
search meets massive exact ties. A stable descending sort keeps ties in
index order, which is the JAX rule exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_large(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of a 2-D
    tensor, in descending order, ties lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
