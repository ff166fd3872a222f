"""Training losses of the port: timestamp-smoothed case-invariant decoder CE
and the joint CTC term.

Counterpart of ts_asr_whisper_tpu/models/losses.py:33-139, the same math in
PyTorch: timestamp rows of the soft-target CE are one (..., 1501) dot with a
row of the Gaussian smoothing matrix; case invariance is the per-token
minimum of the lower-case and upper-case losses; CTC labels drop the prefix
columns, EOS and (optionally) timestamp/task tokens, then left-pack stably.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..ops.ctc import ctc_loss_from_padded_labels
from .config import DiCoWConfig

TIMESTAMP_SIGMA = 0.08
NUM_TIMESTAMPS = 30 * 50 + 1  # <|0.00|> .. <|30.00|>


@lru_cache(maxsize=2)
def timestamp_smoothing_matrix(sigma: float = TIMESTAMP_SIGMA) -> np.ndarray:
    """(1501, 1501) row-normalized Gaussian over timestamp *times*.
    Timestamp token ids are the contiguous block [timestamp_begin, vocab)."""
    times = 0.02 * np.arange(NUM_TIMESTAMPS, dtype=np.float64)
    diff_sq = (times[:, None] - times[None, :]) ** 2
    w = np.exp(-diff_sq / (2 * sigma**2))
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@lru_cache(maxsize=8)
def timestamp_smoothing_on(device: torch.device) -> torch.Tensor:
    """``timestamp_smoothing_matrix()`` on ``device``, copied there once: a
    copy per step from pageable host memory would wait for the card. Read
    only."""
    return torch.from_numpy(timestamp_smoothing_matrix()).to(device)


def soft_ce_token_loss(log_probs: torch.Tensor, labels: torch.Tensor,
                       timestamp_begin: int,
                       ts_matrix: torch.Tensor) -> torch.Tensor:
    """Per-token CE against (timestamp-smoothed) soft targets. log_probs
    (..., V) fp32 log-softmax, labels (...) with -100 = pad."""
    safe = labels.clamp_min(0)
    hard = -torch.gather(log_probs, -1, safe[..., None])[..., 0]
    is_ts = labels >= timestamp_begin
    ts_idx = (labels - timestamp_begin).clamp(0, NUM_TIMESTAMPS - 1)
    weights = ts_matrix[ts_idx]                        # (..., 1501)
    soft = -(weights * log_probs[..., timestamp_begin:]).sum(dim=-1)
    return torch.where(is_ts, soft, hard)


def _hard_ce(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(log_probs, -1, labels.clamp_min(0)[..., None])[..., 0]


def decoder_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    upp_labels: Optional[torch.Tensor], cfg: DiCoWConfig,
                    use_timestamp_smoothing: bool = True,
                    n_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the non-pad tokens of min(loss(lower), loss(upper)): the
    token sum over ``n_tokens`` (default: the non-pad tokens of ``labels``;
    under data parallelism the global batch's, so that this is the rank's
    share of the global batch's mean)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    tb = cfg.timestamp_begin
    if use_timestamp_smoothing:
        ts = timestamp_smoothing_on(log_probs.device)

        def token_loss(lab):
            return soft_ce_token_loss(log_probs, lab, tb, ts)
    else:
        def token_loss(lab):
            return _hard_ce(log_probs, lab)
    tok = token_loss(labels)
    if upp_labels is not None:
        tok = torch.minimum(tok, token_loss(upp_labels))
    mask = (labels != -100).float()
    if n_tokens is None:
        n_tokens = mask.sum().clamp_min(1.0)
    return (tok * mask).sum() / n_tokens


def left_pack(values: torch.Tensor, keep: torch.Tensor,
              fill: int) -> torch.Tensor:
    """Stable left-pack of kept entries along the last axis."""
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    return torch.gather(torch.where(keep, values, fill), -1, order)


def prepare_ctc_labels(labels: torch.Tensor, cfg: DiCoWConfig,
                       num_prefix_tokens: int) -> torch.Tensor:
    """Decoder labels -> CTC labels: the ``num_prefix_tokens`` leading
    columns dropped, EOS mapped to pad, and with
    ``remove_timestamps_from_ctc`` every timestamp/task token removed; the
    rest left-packed."""
    if num_prefix_tokens > 0:
        labels = labels[:, num_prefix_tokens:]
    keep = labels >= 0
    keep &= labels != cfg.eos_token_id
    if cfg.remove_timestamps_from_ctc:
        keep &= labels < cfg.first_task_token
    return left_pack(labels, keep, -100)


def dicow_loss(dec_logits: torch.Tensor,
               enc_ctc_logits: Optional[torch.Tensor], labels: torch.Tensor,
               upp_labels: Optional[torch.Tensor], cfg: DiCoWConfig,
               num_prefix_tokens: int = 0,
               use_timestamp_smoothing: bool = True,
               n_tokens: Optional[torch.Tensor] = None, world: int = 1):
    """Joint loss (1 - w) * CE + w * CTC. Returns (total, dict of parts).

    Data parallelism over ``world`` ranks, each holding the same number of
    rows: with ``n_tokens`` the global batch's token count, the total and
    each part are this rank's shares of the global batch's loss (the loss
    the JAX step takes over the whole batch): summed over the ranks they
    give it. The CE share is the local token sum over ``n_tokens``, the CTC
    share the local term over ``world`` under ``ctc_loss_reduction='mean'``
    (a mean over rows) and the local sum under ``'sum'``."""
    dec_loss = decoder_ce_loss(dec_logits, labels, upp_labels, cfg,
                               use_timestamp_smoothing, n_tokens)
    parts = {"dec_loss": dec_loss}
    if cfg.ctc_weight > 0.0 and enc_ctc_logits is not None:
        ctc_labels = prepare_ctc_labels(labels, cfg, num_prefix_tokens)
        ctc = ctc_loss_from_padded_labels(
            enc_ctc_logits, ctc_labels, blank_id=cfg.ctc_vocab_size - 1,
            reduction=cfg.ctc_loss_reduction)
        if world > 1 and cfg.ctc_loss_reduction == "mean":
            ctc = ctc / world
        parts["ctc_loss"] = ctc
        total = (1.0 - cfg.ctc_weight) * dec_loss + cfg.ctc_weight * ctc
    else:
        total = dec_loss
    parts["loss"] = total
    return total, parts
