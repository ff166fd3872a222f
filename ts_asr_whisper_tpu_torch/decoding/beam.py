"""Beam search of the port.

Counterpart of ts_asr_whisper_tpu/decoding/beam.py::beam_search with every
KV-cache strategy of its reorder switch (ops/reorder.py, beam.py:197-241):

- 'ancestry_pallas' (the default on the card) and 'ancestry': the cache is
  never permuted; ``hist[b, t]`` records which row of b's beam group holds
  b's K/V at position t, and each step's self-attention reads through it
  (models/whisper.py::decoder_cached_ancestry; the CUDA ancestry kernel for
  '_pallas', its plain version for 'ancestry'). 'bhtd' layout only.
- 'pallas' (the default elsewhere), 'onehot', 'fused' and 'fused_onehot':
  a permute of ``cache["k"]`` and ``cache["v"]`` every step before the
  decoder step (``beam_reorder``; the CUDA kv_reorder kernels for 'pallas'
  in the 'bhtd' and 'tbhd' layouts; in place for the 'fused' two).

HF beam semantics as the JAX package: 2n candidates per audio row, the
finished pool from the top-n candidates, length penalty
``score / gen_len**lp``, the early-stopping heuristic, and the CTC rescorer
state reordered by beam index in every branch. The ``lax.while_loop``
becomes a Python loop with one host sync per step for its condition. Ties
are broken as ``lax.top_k`` breaks them, lower index first (ops/topk.py);
the candidate top-k over the (B, n * V) scores follows the switch
``ops/topk.py::set_topk_impl`` (beam.py:152-154). Under
``gen_cfg.cross_kv_quant`` the cross-KV is int8 (models/whisper.py::
quantize_cross_kv) on every cache strategy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.dicow import DiCoW
from ..models.whisper import get_kv_cache_layout, quantize_cross_kv
from ..ops.reorder import beam_reorder, get_reorder_impl
from ..ops.topk import topk_large, topk_lax
from .generation_config import GenerationConfig
from .logits_process import make_logits_processor

NEG = -1e9

# beam steps run (loop iterations), summed over calls: a run's launch counts
# of the step's kernels are checked against it
counters = {"beam_steps": 0}


class BeamOutput(NamedTuple):
    sequences: torch.Tensor       # (B, total_len) best finished beam
    lengths: torch.Tensor         # (B,)
    scores: torch.Tensor          # (B,) length-penalized score (HF
    #                               sequences_scores; the logprob value of
    #                               the no-speech and fallback checks)
    no_speech_probs: torch.Tensor  # (B,) P(no-speech token) at the SOT step


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over dim 1 for (B, k) indices into (B, m, ...)."""
    return x.gather(1, idx.view(*idx.shape, *([1] * (x.dim() - 2)))
                    .expand(*idx.shape, *x.shape[2:]))


@torch.no_grad()
def beam_search(
    model: DiCoW,
    gen_cfg: GenerationConfig,
    encoder_hidden: torch.Tensor,   # (B, T_enc, D)
    init_tokens: torch.Tensor,      # (B, P)
    max_new_tokens: int,
    num_beams: int,
    ctc_scorer=None,
    ctc_state=None,
) -> BeamOutput:
    dec = model.decoder
    dev = encoder_hidden.device
    b, prompt_len = init_tokens.shape
    n = num_beams
    bb = b * n
    total_len = prompt_len + max_new_tokens
    pad = gen_cfg.pad_token_id
    eos = gen_cfg.eos_token_id
    lp = gen_cfg.length_penalty if gen_cfg.length_penalty is not None \
        else 1.0
    vocab = dec.cfg.vocab_size
    k2 = 2 * n

    process = make_logits_processor(gen_cfg, begin_index=prompt_len,
                                    device=dev)
    # cross-KV per audio row: the n beams share it (query fold)
    cross_kv = dec.precompute_cross_kv(encoder_hidden)
    if gen_cfg.cross_kv_quant:
        cross_kv = quantize_cross_kv(cross_kv)
    cache = dec.init_kv_cache(bb, total_len, dev)
    w_logits = dec.embed_tokens.weight.to(dec.cfg.compute_dtype).float()

    tokens = torch.full((b, n, total_len), pad, dtype=torch.long, device=dev)
    tokens[:, :, :prompt_len] = init_tokens.to(dev)[:, None, :]

    # prefill all hypotheses (identical per beam)
    hidden = dec.decoder_cached(tokens.reshape(bb, total_len)[:, :prompt_len],
                                0, cache, cross_kv)
    logits = dec.lm_logits(hidden[:, -1], w_logits)
    no_speech_token = gen_cfg.no_timestamps_token_id - 1
    sot_logits = dec.lm_logits(hidden[:, 0], w_logits)
    no_speech_probs = torch.softmax(sot_logits.reshape(b, n, vocab)[:, 0],
                                    dim=-1)[:, no_speech_token]

    running_scores = torch.full((b, n), NEG, device=dev)
    running_scores[:, 0] = 0.0
    fin_tokens = tokens.clone()
    fin_scores = torch.full((b, n), NEG, device=dev)
    fin_lengths = torch.full((b, n), prompt_len, dtype=torch.long, device=dev)
    is_finished = torch.zeros((b, n), dtype=torch.bool, device=dev)
    impl = get_reorder_impl(device=dev)
    layout = get_kv_cache_layout()
    ancestry = impl.startswith("ancestry")
    # prefill rows are identical per group, so each row's history is its own
    # row at every position
    group_rows = torch.arange(n, dtype=torch.int32, device=dev).repeat(b)
    if ancestry:
        hist = group_rows[:, None].repeat(1, total_len)
    group_base = torch.arange(b, device=dev)[:, None] * n

    def improvement_possible(cur_len: int) -> torch.Tensor:
        all_full = is_finished.all(dim=1)
        if gen_cfg.early_stopping:
            return ~all_full
        gen_len = float(max(cur_len + 1 - prompt_len, 1))
        best_running = running_scores.amax(dim=1) / gen_len ** lp
        worst_finished = torch.where(is_finished.any(dim=1),
                                     fin_scores.amin(dim=1), NEG)
        return ~(all_full & (worst_finished >= best_running))

    cur_len = prompt_len
    while cur_len < total_len and bool(improvement_possible(cur_len).any()):
        counters["beam_steps"] += 1
        flat_tokens = tokens.reshape(bb, total_len)
        log_probs = torch.log_softmax(logits, dim=-1)
        log_probs = process(log_probs, flat_tokens, cur_len)
        if ctc_scorer is not None:
            log_probs, ctc_state = ctc_scorer.rescore(
                ctc_state, flat_tokens, cur_len, log_probs)

        scores = log_probs.reshape(b, n, vocab) + running_scores[..., None]
        top_scores, top_idx = topk_large(scores.reshape(b, n * vocab), k2)
        src_beam = top_idx // vocab                            # (B, 2n)
        next_tok = top_idx % vocab
        is_eos = next_tok == eos

        # finished pool from the top-n candidates
        gen_len = float(cur_len + 1 - prompt_len)
        cand_fin_scores = top_scores / max(gen_len, 1.0) ** lp
        eligible = is_eos & (torch.arange(k2, device=dev)[None, :] < n)
        cand_fin_scores = torch.where(eligible, cand_fin_scores, NEG)
        merged_scores = torch.cat([fin_scores, cand_fin_scores], dim=1)
        cand_seqs = _take(tokens, src_beam).clone()            # (B, 2n, L)
        cand_seqs[:, :, cur_len] = next_tok
        merged_seqs = torch.cat([fin_tokens, cand_seqs], dim=1)
        merged_lens = torch.cat(
            [fin_lengths, torch.full((b, k2), cur_len + 1, dtype=torch.long,
                                     device=dev)], dim=1)
        best = topk_lax(merged_scores, n)[1]                   # (B, n)
        fin_scores = merged_scores.gather(1, best)
        fin_tokens = _take(merged_seqs, best)
        fin_lengths = merged_lens.gather(1, best)
        is_finished = fin_scores > NEG

        # next n running beams among the non-eos candidates
        run_scores = torch.where(is_eos, NEG, top_scores)
        order = topk_lax(run_scores, n)[1]                     # (B, n)
        running_scores = run_scores.gather(1, order)
        chosen_beam = src_beam.gather(1, order)
        chosen_tok = next_tok.gather(1, order)
        tokens = _take(tokens, chosen_beam).clone()
        tokens[:, :, cur_len] = chosen_tok

        # reorder the cache (or its ancestry map) and the CTC state by the
        # flat beam index
        flat_beam_idx = (group_base + chosen_beam).reshape(bb)
        if ancestry:
            # append-only cache: the ancestry map inherits the chosen
            # ancestor's history and claims this step's slot for the row
            hist = hist[flat_beam_idx]
            hist[:, cur_len] = group_rows
        else:
            cache = {key: beam_reorder(c, chosen_beam, n, flat_beam_idx,
                                       layout)
                     for key, c in cache.items()}
        if ctc_scorer is not None:
            ctc_state = ctc_scorer.update_state(
                ctc_state, chosen_tok.reshape(bb), flat_beam_idx)

        if ancestry:
            hidden = dec.decoder_cached_ancestry(
                chosen_tok.reshape(bb, 1), cur_len, cache, cross_kv, hist, n,
                attn_impl="kernel" if impl == "ancestry_pallas" else "plain")
        else:
            hidden = dec.decoder_cached(chosen_tok.reshape(bb, 1), cur_len,
                                        cache, cross_kv)
        logits = dec.lm_logits(hidden[:, -1], w_logits)
        cur_len += 1

    # a batch row that finished nothing falls back to its best running beam
    gen_len = float(max(cur_len - prompt_len, 1))
    run_penalized = running_scores / gen_len ** lp
    none_finished = ~is_finished.any(dim=1)
    pick = torch.where(none_finished, run_penalized.argmax(dim=1),
                       fin_scores.argmax(dim=1))[:, None]
    seq_fin = _take(fin_tokens, pick)[:, 0]
    seq_run = _take(tokens, pick)[:, 0]
    sequences = torch.where(none_finished[:, None], seq_run, seq_fin)
    lengths = torch.where(none_finished,
                          torch.full_like(fin_lengths[:, 0], cur_len),
                          fin_lengths.gather(1, pick)[:, 0])
    scores = torch.where(none_finished, run_penalized.gather(1, pick)[:, 0],
                         fin_scores.gather(1, pick)[:, 0])
    return BeamOutput(sequences, lengths, scores, no_speech_probs)
