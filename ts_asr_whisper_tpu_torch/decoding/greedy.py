"""Greedy KV-cached decode of one 30 s window batch.

Counterpart of ts_asr_whisper_tpu/decoding/greedy.py: the
``lax.while_loop`` becomes a Python loop over a preallocated token buffer
that stops once every row has emitted EOS. Cross-attention K/V are computed
once per window (int8 under ``gen_cfg.cross_kv_quant``) into the decoder's
pooled buffers (``WhisperDecoder.greedy_buffers``). Its self-attention
cache is the pooled entry itself, written in place: ``decoder_cached``
knows it by its type and runs each step on it as a replayed CUDA graph on
the card. The host reads whether every row has finished one step
late: each step copies ``finished.all()`` to the host without waiting, and
the next step but one waits for that copy (the ``greedy.stop_check`` span
beside each step's ``greedy.step``), so the host launches a step while the
device runs the one before. The loop may thus run one step past the last
EOS; that step writes pad and adds 0 to ``sum_logprobs``.
With a CTC rescorer (decoding/ctc_rescorer.py) the joint CTC scores join the
attention scores inside the same loop (greedy.py:106-124). A temperature
above 0 samples each token from softmax(scores / T) (the fallback retries of
decoding/longform.py); with ``alignment_slots`` the loop collects the
alignment heads' cross-attention probabilities for token timestamps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.dicow import DiCoW
from ..utils.observability import count, span
from .generation_config import GenerationConfig
from .logits_process import make_logits_processor


class GreedyOutput(NamedTuple):
    sequences: torch.Tensor       # (B, total_len) pad-filled
    lengths: torch.Tensor         # (B,) valid token count incl. prompt
    sum_logprobs: torch.Tensor    # (B,) sum of selected-token logprobs
    no_speech_probs: torch.Tensor  # (B,) P(no-speech token) at the SOT step
    # token-timestamp mode only: the alignment heads' cross-attention
    # probabilities per generated-token query, (B, S, max_new, T_enc) fp32;
    # row j = query position prompt_len + j (greedy.py:36-40)
    alignment_weights: Optional[torch.Tensor] = None


def sample(scores: torch.Tensor, temperature: float,
           generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(scores / temperature), on the device
    of ``scores`` with ``generator`` (greedy.py:112-117 draws with
    ``jax.random.categorical``; the same distribution, other bits). Tokens
    at -inf have probability 0 and are never drawn."""
    probs = torch.softmax(scores / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def greedy_decode(
    model: DiCoW,
    gen_cfg: GenerationConfig,
    encoder_hidden: torch.Tensor,   # (B, T_enc, D)
    init_tokens: torch.Tensor,      # (B, P) prompt incl. decoder_start
    max_new_tokens: int,
    force_full_length: bool = False,  # benchmarking: ignore the EOS exit
    ctc_scorer=None,                # optional: decoding/ctc_rescorer.py
    ctc_state=None,
    temperature: float = 0.0,       # > 0: sampling (fallback retries)
    generator: Optional[torch.Generator] = None,  # the sampler's, on dev
    alignment_slots: Optional[torch.Tensor] = None,  # (L, S, H) token-ts
) -> GreedyOutput:
    dec = model.decoder
    dev = encoder_hidden.device
    b, prompt_len = init_tokens.shape
    total_len = prompt_len + max_new_tokens
    pad = gen_cfg.pad_token_id
    eos = gen_cfg.eos_token_id
    no_speech_token = gen_cfg.no_timestamps_token_id - 1
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    process = make_logits_processor(gen_cfg, begin_index=prompt_len,
                                    device=dev)
    cache, cross_kv = dec.greedy_buffers(encoder_hidden, b, total_len,
                                         gen_cfg.cross_kv_quant)
    # logits weight cast once per window, not once per step
    w_logits = dec.embed_tokens.weight.to(dec.cfg.compute_dtype).float()
    align_buf = None
    if alignment_slots is not None:
        alignment_slots = alignment_slots.to(dev)
        align_buf = torch.zeros(
            (b, alignment_slots.shape[1], max_new_tokens,
             encoder_hidden.shape[1]), dtype=torch.float32, device=dev)

    tokens = torch.full((b, total_len), pad, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = init_tokens.to(dev)

    # prefill the prompt
    hidden = dec.decoder_cached(tokens[:, :prompt_len], 0, cache, cross_kv)
    logits = dec.lm_logits(hidden[:, -1], w_logits)
    # no-speech prob from the logits AT the <|startoftranscript|> position
    # (greedy.py:81-86, HF WhisperNoSpeechDetection)
    sot_logits = dec.lm_logits(hidden[:, 0], w_logits)
    no_speech_probs = torch.softmax(sot_logits, dim=-1)[:, no_speech_token]

    cur_len = prompt_len
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_logprobs = torch.zeros(b, dtype=torch.float32, device=dev)
    # finished.all() of the last two steps, on the host (pinned on the card)
    on_card = dev.type == "cuda"
    done_flags = [torch.zeros((), dtype=torch.bool, pin_memory=on_card)
                  for _ in range(2)]
    done_events = [torch.cuda.Event() for _ in range(2)] if on_card else None
    while cur_len < total_len:
        step = cur_len - prompt_len
        if not force_full_length:
            # the step's one host sync: wait for the flag of the step
            # before the last, while the device runs the last
            with span("greedy.stop_check"):
                done = False
                if step >= 2:
                    if on_card:
                        done_events[step % 2].synchronize()
                    done = bool(done_flags[step % 2])
            if done:
                break
        with span("greedy.step"):
            scores = process(logits, tokens, cur_len)
            if ctc_scorer is not None:
                scores = torch.log_softmax(scores, dim=-1)
                scores, ctc_state = ctc_scorer.rescore(ctc_state, tokens,
                                                       cur_len, scores)
            if temperature > 0.0:
                next_tok = sample(scores, temperature, generator)
            else:
                next_tok = scores.argmax(dim=-1)
            next_tok = torch.where(finished, pad, next_tok)
            logp = torch.log_softmax(scores, dim=-1)
            tok_logp = logp.gather(1, next_tok[:, None])[:, 0]
            sum_logprobs += torch.where(finished, 0.0, tok_logp)
            if ctc_scorer is not None:
                ctc_state = ctc_scorer.update_state(ctc_state, next_tok, None)
            tokens[:, cur_len] = next_tok
            finished |= next_tok == eos
            if align_buf is None:
                hidden = dec.decoder_cached(next_tok[:, None], cur_len, cache,
                                            cross_kv)
            else:
                hidden, probs = dec.decoder_cached(
                    next_tok[:, None], cur_len, cache, cross_kv,
                    alignment_slots=alignment_slots)
                # the query row of position cur_len (generated token
                # cur_len - prompt_len)
                align_buf[:, :, cur_len - prompt_len] = probs[:, :, 0]
            logits = dec.lm_logits(hidden[:, -1], w_logits)
            if not force_full_length:
                done_flags[step % 2].copy_(finished.all(), non_blocking=True)
                if on_card:
                    done_events[step % 2].record()
        count("greedy.steps")
        cur_len += 1

    # valid length = prompt + tokens up to and including the first EOS
    positions = torch.arange(total_len, device=dev)
    is_eos = (tokens == eos) & (positions[None, :] >= prompt_len)
    first_eos = torch.where(is_eos.any(dim=1),
                            is_eos.int().argmax(dim=1),
                            torch.full((b,), cur_len - 1, device=dev))
    lengths = torch.clamp(first_eos + 1, max=cur_len)
    return GreedyOutput(tokens, lengths, sum_logprobs, no_speech_probs,
                        align_buf)
