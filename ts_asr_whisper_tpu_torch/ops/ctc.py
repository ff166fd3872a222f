"""CTC loss and greedy CTC decode of the port.

Counterpart of ts_asr_whisper_tpu/ops/ctc.py:29-135 (``ctc_loss``,
``ctc_loss_from_padded_labels``, ``ctc_greedy_decode``). The JAX package
writes the alpha recursion as a ``lax.scan`` for XLA; it has no Pallas
kernel, so here it is PyTorch's ``F.ctc_loss`` over ``log_softmax`` of the
fp32 logits, with the same conventions: blank = the last vocab index,
``reduction='mean'`` divides each sequence's NLL by its target length (at
least 1) before the batch mean, and ``zero_infinity`` zeroes the loss (and
gradient) of an impossible alignment.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int, reduction: str = "mean",
             zero_infinity: bool = True) -> torch.Tensor:
    """Negative log-likelihood of the CTC alignment lattice. logits
    (B, T, V) raw, labels (B, U) padded with any negative value."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = F.ctc_loss(log_probs.transpose(0, 1), labels.clamp_min(0),
                     logit_lengths, label_lengths, blank=blank_id,
                     reduction="none", zero_infinity=zero_infinity)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / label_lengths.clamp_min(1)).mean()


def ctc_loss_from_padded_labels(logits: torch.Tensor, labels: torch.Tensor,
                                blank_id: int,
                                logit_lengths: Optional[torch.Tensor] = None,
                                reduction: str = "mean") -> torch.Tensor:
    """Full-length logits and -100-padded left-aligned labels."""
    b, t_max, _ = logits.shape
    if logit_lengths is None:
        logit_lengths = torch.full((b,), t_max, dtype=torch.long,
                                   device=logits.device)
    label_lengths = (labels >= 0).sum(dim=-1)
    return ctc_loss(logits, labels, logit_lengths, label_lengths, blank_id,
                    reduction=reduction)


def ctc_greedy_decode(logits: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Collapse repeats and drop blanks (ops/ctc.py:125-135): (B, T, V)
    logits -> (B, T) token ids, left-aligned and padded with -1. Ties in
    the argmax go to the first index, as ``jnp.argmax``."""
    ids = logits.argmax(dim=-1)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != prev) & (ids != blank_id)
    # stable left-pack of the kept positions
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    return torch.gather(torch.where(keep, ids, -1), 1, order)
