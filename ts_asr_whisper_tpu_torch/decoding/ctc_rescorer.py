"""Joint CTC rescoring inside the decode loop of the port.

Counterpart of ts_asr_whisper_tpu/decoding/ctc_rescorer.py: per step, the
top-K attention candidates (+EOS) get CTC prefix scores; fused score =
(1-w)*attention + w*(psi - psi_prev); timestamp tokens are transparent (they
take the row-max CTC score and do not advance the CTC state). The prefix
bookkeeping reproduces the JAX package's (and the reference's) positional
"last label" gather bit for bit.

Beam mode (n > 1) scores the candidate set as a vocab membership mask with
one of two psi paths: ``'gather'`` (ops/psi_gather.py, the CUDA gather + dot
kernel on the card) or ``'matmul'`` (the full-vocab beam-shared matmul of
ops/ctc_prefix.py). ``'auto'`` takes the kernel on CUDA and the matmul on the
CPU, as the JAX package takes its kernel on TPU only. Single-hypothesis
decode keeps the top-K id list and the closed form of ctc_prefix_scores.
With ``debug`` every rescore prints the reference's per-step table (top 10
by attention, by CTC with timestamps blanked, fused, and the CTC EOS score;
ctc_rescorer.py:146-186, 313-323): the few small tensors it needs are
fetched to the host only then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.ctc_prefix import (
    LOG_ZERO,
    ctc_prefix_scores,
    ctc_psi_matmul,
    initial_ctc_state,
    kth_largest_keys,
)
from ..ops.psi_gather import ctc_psi_candidates, padded_posterior
from ..ops.topk import topk_lax


class CTCState(NamedTuple):
    logp_vt: torch.Tensor           # (B_audio, V, T) case-folded log-probs
    p_tv: Optional[torch.Tensor]    # (B_audio, T, V) probabilities for the
    #                                 beam-shared matmul ('matmul' only)
    p_vt: Optional[torch.Tensor]    # (B_audio, V, T) probabilities, rows
    #                                 16-byte aligned, for the gather kernel
    #                                 ('gather' only; the JAX package's p4
    #                                 without its TPU time fold)
    audio_idx: torch.Tensor         # (Bb,) int32 hypothesis -> audio row
    r_prev: torch.Tensor            # (Bb, T, 2)
    score_prev: torch.Tensor        # (Bb,)
    cand_ids: torch.Tensor          # (Bb, K) ids (n=1) or (Bb, V_dec) mask
    decoded_len: torch.Tensor       # (Bb,) prefix stats at rescore time
    last_label: torch.Tensor        # (Bb,)


def resolve_psi_impl(impl: str, device: torch.device) -> str:
    """Beam-mode psi strategy: 'auto' is the candidate gather kernel on CUDA
    and the full-vocab matmul on the CPU (ctc_rescorer.py:60-70, with the
    card in the TPU's place); 'matmul' and 'gather' are explicit."""
    if impl == "auto":
        return "gather" if torch.device(device).type == "cuda" else "matmul"
    if impl not in ("matmul", "gather"):
        raise ValueError(f"ctc_psi_impl={impl!r}: want auto|matmul|gather")
    return impl


@torch.no_grad()
def init_ctc_state(enc_logits: torch.Tensor, blank: int,
                   upper_to_lower: Optional[np.ndarray] = None,
                   num_beams: int = 1, k: int = 500, p_bf16: bool = False,
                   psi_impl: str = "auto") -> CTCState:
    """enc_logits: (B_audio, T, V) raw CTC-head logits. upper_to_lower:
    (2, n_pairs) [upper ids; lower ids]; upper-case columns take their lower-
    case column's log-prob (ctc_rescorer.py:73-139). The posterior for the
    beam psi is fp32 unless ``p_bf16``."""
    dev = enc_logits.device
    logp = torch.log_softmax(enc_logits.float(), dim=-1)
    if upper_to_lower is not None and np.asarray(upper_to_lower).size:
        pairs = torch.as_tensor(np.asarray(upper_to_lower), dtype=torch.long,
                                device=dev)
        logp[..., pairs[0]] = logp[..., pairs[1]]
    b_audio = logp.shape[0]
    bb = b_audio * num_beams
    # int32 once here: the psi kernel takes it as it is, with no cast on the
    # card per beam step
    audio_idx = torch.arange(bb, dtype=torch.int32, device=dev) // num_beams
    r0, _ = initial_ctc_state(logp, blank)
    v_dec = logp.shape[-1] - 1  # decoder vocab (ctc vocab minus blank)
    logp_vt = logp.transpose(1, 2).contiguous()
    p_tv = p_vt = None
    if num_beams > 1:
        p_dtype = torch.bfloat16 if p_bf16 else torch.float32
        if resolve_psi_impl(psi_impl, dev) == "gather":
            p_vt = padded_posterior(torch.exp(logp_vt), p_dtype)
        else:
            p_tv = torch.exp(logp).to(p_dtype)
    cand = (torch.zeros((bb, v_dec), dtype=torch.bool, device=dev)
            if num_beams > 1
            else torch.zeros((bb, k), dtype=torch.long, device=dev))
    return CTCState(
        logp_vt=logp_vt, p_tv=p_tv, p_vt=p_vt, audio_idx=audio_idx,
        r_prev=r0[audio_idx],
        score_prev=torch.zeros(bb, dtype=torch.float32, device=dev),
        cand_ids=cand,
        decoded_len=torch.zeros(bb, dtype=torch.long, device=dev),
        last_label=torch.full((bb,), blank, dtype=torch.long, device=dev))


def candidate_mask(scores: torch.Tensor, k: int, eos: int,
                   ts_begin: int) -> torch.Tensor:
    """(Bb, V_dec) beam-mode candidate membership (ctc_rescorer.py:243-261):
    the exact top-k of the text columns with top_k's tie rule (equal values
    in index order), where EOS, when not among them, replaces the k-th
    ranked one (the last selected threshold tie), plus EOS always. At most
    k + 1 bits are set."""
    bb, v_dec = scores.shape
    keys, kth = kth_largest_keys(scores[:, :ts_begin], k)
    greater = keys > kth[:, None]
    ties = keys == kth[:, None]
    m_needed = (k - greater.sum(dim=1))[:, None]
    tie_rank = torch.cumsum(ties.to(torch.int32), dim=1)
    topk = greater | (ties & (tie_rank <= m_needed))
    if eos < ts_begin:
        has_eos = topk[:, eos]
    else:
        has_eos = torch.zeros(bb, dtype=torch.bool, device=scores.device)
    displaced = ties & (tie_rank == m_needed)
    topk = torch.where(has_eos[:, None], topk, topk & ~displaced)
    mask = torch.zeros((bb, v_dec), dtype=torch.bool, device=scores.device)
    mask[:, :ts_begin] = topk
    mask[:, eos] = True
    return mask


# host-side token decoder for the joint-decode debug dump; None prints ids
_DEBUG_DECODER = None


def set_joint_debug_decoder(decode_fn) -> None:
    """Register ``decode_fn(ids) -> str`` (e.g. tokenizer.decode) so the
    debug dump prints token text instead of raw ids."""
    global _DEBUG_DECODER
    _DEBUG_DECODER = decode_fn


def _debug_print(step_tokens, cur_len, att_v, att_i, ctc_v, ctc_i,
                 fused_v, fused_i, ctc_eos):
    """Host callback: the reference's ``analyze_predictions`` table
    (decoding.py:214-266) — per hypothesis, the top-k candidates by
    attention, CTC and fused score, plus the running prefix and the CTC
    EOS score."""
    def tok_str(i):
        if _DEBUG_DECODER is None:
            return str(int(i))
        try:
            return repr(_DEBUG_DECODER([int(i)]))
        except Exception:
            return str(int(i))

    print("\n" + "#" * 100)
    for b in range(att_i.shape[0]):
        print("-" * 80)
        print(f"HYPOTHESIS {b}")
        prefix = [int(t) for t in step_tokens[b][: int(cur_len)]]
        if _DEBUG_DECODER is not None:
            try:
                prefix = _DEBUG_DECODER(prefix)
            except Exception:
                pass
        print(f"\nPREFIX:\n{prefix}")
        for title, ids, vals in (("ATT_TOKENS", att_i[b], att_v[b]),
                                 ("CTC_TOKENS", ctc_i[b], ctc_v[b]),
                                 ("NEXT_TOKENS", fused_i[b], fused_v[b])):
            cells = [f"{tok_str(i)}:{float(v):.2f}"
                     for i, v in zip(ids, vals)]
            print(f"\n{title}: " + " | ".join(cells))
        print(f"\nCTC_EOS: {float(ctc_eos[b]):.2f}\n")
    print("#" * 100, flush=True)


@dataclass(frozen=True)
class CTCRescorer:
    """Static config of joint CTC rescoring (ctc_rescorer.py:188-200)."""

    blank_id: int
    eos_id: int
    timestamp_begin: int     # vocab id of <|0.00|>
    ctc_weight: float
    k: int = 500
    prefix_len: int = 3      # len(tokenizer.prefix_tokens)
    # the per-step top-k att/CTC/fused dump (reference analyze_predictions,
    # decoding.py:214-266); no cost when False
    debug: bool = False

    @property
    def k_pad(self) -> int:
        """Candidate slots of the gather path: k + 1 rounded up to 128."""
        return -(-(self.k + 1) // 128) * 128

    def _prefix_stats(self, tokens: torch.Tensor, cur_len: int):
        """Reference prefix transformations (ctc_rescorer.py:202-223): the
        transformed sequence is tokens[:, strip:cur_len] with element 0 set
        to blank."""
        strip = self.prefix_len - 1 if self.prefix_len > 1 else 0
        bb, buf_len = tokens.shape
        pos = torch.arange(buf_len, device=tokens.device)
        in_seq = (pos >= strip) & (pos < cur_len)
        vals = torch.where(pos[None, :] == strip, self.blank_id, tokens)
        is_text_or_blank = ((vals < self.timestamp_begin)
                            | (vals == self.blank_id)) & in_seq[None, :]
        decoded_len = (((vals <= self.timestamp_begin)
                        & (vals != self.blank_id)) & in_seq[None, :]) \
            .sum(dim=1)
        last_raw = vals[:, max(cur_len - 1, 0)]
        last_is_ts = (last_raw >= self.timestamp_begin) \
            & (last_raw != self.blank_id)
        gather_idx = strip + is_text_or_blank.sum(dim=1) - 1
        gathered = vals.gather(1, gather_idx[:, None])[:, 0]
        gathered = torch.where(gather_idx == strip, self.blank_id, gathered)
        last = torch.where(last_is_ts, gathered, last_raw)
        return decoded_len, last

    def rescore(self, state: CTCState, tokens: torch.Tensor, cur_len: int,
                scores: torch.Tensor) -> Tuple[torch.Tensor, CTCState]:
        """scores: (Bb, V_dec) attention log-probs after the processors.
        Returns (fused scores, state with the candidate slots filled)."""
        bb, v_dec = scores.shape
        decoded_len, last_label = self._prefix_stats(tokens, cur_len)

        if state.p_tv is not None or state.p_vt is not None:
            cand_mask = candidate_mask(scores, self.k, self.eos_id,
                                       self.timestamp_begin)
            xl = state.logp_vt[state.audio_idx, last_label]  # (Bb, T)
            if state.p_vt is not None:
                tmp = ctc_psi_candidates(
                    state.p_vt, cand_mask, state.audio_idx, xl, state.r_prev,
                    decoded_len, last_label, self.eos_id, k_pad=self.k_pad)
            else:
                psi_all = ctc_psi_matmul(
                    state.p_tv, xl, state.r_prev, decoded_len, last_label,
                    self.blank_id, self.eos_id)
                tmp = torch.where(cand_mask, psi_all[:, :v_dec], LOG_ZERO)
            cand_ids = cand_mask
        else:
            # top-K text candidates (+ EOS always, in the K-th slot)
            _, cand_ids = topk_lax(scores[:, : self.timestamp_begin],
                                   self.k)
            has_eos = (cand_ids == self.eos_id).any(dim=1)
            cand_ids = cand_ids.clone()
            cand_ids[:, self.k - 1] = torch.where(
                has_eos, cand_ids[:, self.k - 1], self.eos_id)
            log_psi, _ = ctc_prefix_scores(
                state.logp_vt, state.audio_idx, cand_ids, state.r_prev,
                decoded_len, last_label, self.blank_id, self.eos_id,
                with_states=False)
            tmp = torch.full((bb, v_dec), LOG_ZERO, dtype=torch.float32,
                             device=scores.device)
            tmp.scatter_(1, cand_ids, log_psi)
        # timestamp transparency: timestamps take the row max
        row_max = tmp.amax(dim=1, keepdim=True)
        is_ts = (torch.arange(v_dec, device=scores.device)
                 >= self.timestamp_begin)[None, :]
        tmp = torch.where(is_ts, row_max, tmp)

        ctc_scores = tmp - state.score_prev[:, None]
        fused = (1.0 - self.ctc_weight) * scores \
            + self.ctc_weight * ctc_scores
        if self.debug:
            dk = 10
            att = topk_lax(scores, dk)
            # the reference blanks timestamps before the CTC top-k
            # (decoding.py:221)
            ctc = topk_lax(torch.where(is_ts, LOG_ZERO, ctc_scores), dk)
            top_fused = topk_lax(fused, dk)
            host = [t.cpu().numpy() for t in (
                tokens, att[0], att[1], ctc[0], ctc[1], top_fused[0],
                top_fused[1], ctc_scores[:, self.eos_id])]
            _debug_print(host[0], cur_len, *host[1:])
        return fused, state._replace(cand_ids=cand_ids,
                                     decoded_len=decoded_len,
                                     last_label=last_label)

    def update_state(self, state: CTCState, next_tokens: torch.Tensor,
                     beam_idx: Optional[torch.Tensor]) -> CTCState:
        """Advance the per-hypothesis prefix state after token selection
        (ctc_rescorer.py:330-366): the alpha recursion for the one chosen
        token; timestamps and tokens outside the scored set keep the old
        state."""
        if beam_idx is None:
            beam_idx = torch.arange(next_tokens.shape[0],
                                    device=next_tokens.device)
        r_prev = state.r_prev[beam_idx]
        score_prev = state.score_prev[beam_idx]
        cand_ids = state.cand_ids[beam_idx]
        decoded_len = state.decoded_len[beam_idx]
        last_label = state.last_label[beam_idx]

        chosen_score, chosen_state = ctc_prefix_scores(
            state.logp_vt, state.audio_idx[beam_idx], next_tokens[:, None],
            r_prev, decoded_len, last_label, self.blank_id, self.eos_id)
        chosen_score = chosen_score[:, 0]
        chosen_state = chosen_state[:, 0]

        if cand_ids.dtype == torch.bool:  # beam mode: membership mask
            found = cand_ids.gather(1, next_tokens[:, None])[:, 0]
        else:
            found = (cand_ids == next_tokens[:, None]).any(dim=1)
        advance = (next_tokens < self.timestamp_begin) & found
        return state._replace(
            r_prev=torch.where(advance[:, None, None], chosen_state, r_prev),
            score_prev=torch.where(advance, chosen_score, score_prev),
            cand_ids=cand_ids, decoded_len=decoded_len,
            last_label=last_label)
