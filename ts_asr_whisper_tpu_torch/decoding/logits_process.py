"""Logits processors of the port: repetition penalty -> begin-suppress ->
suppress -> Whisper timestamp rules with the DiCoW EOS-early-exit tweak.

Counterpart of ts_asr_whisper_tpu/decoding/logits_process.py, vectorized
over the batch with torch ops. The current length is a Python int here (the
decode loop runs on the host), where the JAX version traces it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .generation_config import GenerationConfig

NEG_INF = torch.finfo(torch.float32).min


def apply_timestamp_rules(
    scores: torch.Tensor,     # (B, V) fp32
    tokens: torch.Tensor,     # (B, L) token buffer incl. prompt
    cur_len: int,             # number of valid tokens in the buffer
    begin_index: int,
    gen_cfg: GenerationConfig,
    eos_scores_before: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Whisper timestamp constraints + DiCoW EOS-early-exit
    (logits_process.py:31-94)."""
    v = scores.shape[1]
    dev = scores.device
    ts_begin = gen_cfg.timestamp_begin
    eos = gen_cfg.eos_token_id
    vocab_ids = torch.arange(v, device=dev)

    scores = scores.clone()
    scores[:, gen_cfg.no_timestamps_token_id] = NEG_INF

    seq_len = cur_len - begin_index
    last_tok = tokens[:, max(cur_len - 1, 0)]
    penult_tok = tokens[:, max(cur_len - 2, 0)]
    last_was_ts = (last_tok >= ts_begin) & (seq_len >= 1)
    penult_was_ts = (penult_tok >= ts_begin) | (seq_len < 2)

    is_ts_region = (vocab_ids >= ts_begin)[None, :]
    # last ts + penult ts -> must emit non-timestamp
    force_text = (last_was_ts & penult_was_ts)[:, None] & is_ts_region
    # last ts only -> cannot emit normal text (ids < eos)
    force_ts = (last_was_ts & ~penult_was_ts)[:, None] \
        & (vocab_ids < eos)[None, :]
    scores = scores.masked_fill(force_text | force_ts, NEG_INF)

    # last emitted timestamp (timestamps are non-decreasing under these rules)
    positions = torch.arange(tokens.shape[1], device=dev)
    in_window = (positions >= begin_index) & (positions < cur_len)
    is_ts_tok = (tokens >= ts_begin) & in_window[None, :]
    any_ts = is_ts_tok.any(dim=1)
    last_ts_pos = torch.where(is_ts_tok, positions[None, :],
                              torch.full_like(tokens, -1)).amax(dim=1)
    last_ts_val = tokens.gather(1, last_ts_pos.clamp(min=0)[:, None])[:, 0]
    ts_last = torch.where(last_was_ts & ~penult_was_ts, last_ts_val,
                          last_ts_val + 1)
    mono_mask = any_ts[:, None] & is_ts_region \
        & (vocab_ids[None, :] < ts_last[:, None])
    scores = scores.masked_fill(mono_mask, NEG_INF)

    # at the very first generated position: only timestamps allowed...
    at_begin = seq_len == 0
    if at_begin:
        begin_mask = vocab_ids < ts_begin
        if gen_cfg.max_initial_timestamp_index is not None:
            last_allowed = ts_begin + gen_cfg.max_initial_timestamp_index
            begin_mask = begin_mask | (vocab_ids > last_allowed)
        scores = scores.masked_fill(begin_mask[None, :], NEG_INF)

    # if total timestamp probability beats every text token, force a timestamp
    logprobs = torch.log_softmax(scores.float(), dim=-1)
    ts_logprob = torch.logsumexp(logprobs[:, ts_begin:], dim=-1)
    max_text = logprobs[:, :ts_begin].amax(dim=-1)
    force = (ts_logprob > max_text)[:, None] & (vocab_ids < ts_begin)[None, :]
    scores = scores.masked_fill(force, NEG_INF)

    # EOS early-exit on silence: the DiCoW tweak restores the pre-processor
    # EOS score at the first generated position, after every rule above
    if eos_scores_before is not None and at_begin:
        scores[:, eos] = eos_scores_before
    return scores


def make_logits_processor(gen_cfg: GenerationConfig, begin_index: int,
                          device=None):
    """fn(scores, tokens, cur_len) -> scores, in the chain order of
    logits_process.py:97-136. The suppressed ids go to ``device`` once."""
    def ids(tokens) -> torch.Tensor:
        return torch.tensor(tuple(tokens or ()), dtype=torch.long,
                            device=device)

    suppress = ids(gen_cfg.suppress_tokens)
    begin_suppress = ids(gen_cfg.begin_suppress_tokens)
    rep = gen_cfg.repetition_penalty

    def process(scores: torch.Tensor, tokens: torch.Tensor,
                cur_len: int) -> torch.Tensor:
        scores = scores.float()
        if rep is not None and rep != 1.0:
            # HF RepetitionPenaltyLogitsProcessor over every token already
            # in the sequence, prompt included
            present = torch.zeros_like(scores, dtype=torch.bool)
            present.scatter_(1, tokens[:, :cur_len], True)
            scores = torch.where(present,
                                 torch.where(scores < 0, scores * rep,
                                             scores / rep),
                                 scores)
        if begin_suppress.numel() and cur_len == begin_index:
            scores = scores.index_fill(1, begin_suppress, NEG_INF)
        if suppress.numel():
            scores = scores.index_fill(1, suppress, NEG_INF)
        if gen_cfg.return_timestamps:
            eos_before = scores[:, gen_cfg.eos_token_id].clone()
            scores = apply_timestamp_rules(scores, tokens, cur_len,
                                           begin_index, gen_cfg, eos_before)
        return scores

    return process
