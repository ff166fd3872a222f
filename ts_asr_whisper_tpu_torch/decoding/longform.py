"""Long-form (arbitrary-length) decoding of the port: the host-driven seek
loop around the per-window encoder and greedy or beam decode.

Counterpart of ts_asr_whisper_tpu/decoding/longform.py:276-683, device side
in torch: the full-recording features and STNO stay on the device for the
whole call and each window is sliced there; active rows are compacted into a
power-of-2 bucket padded with duplicate rows (the first occurrence wins);
one device->host fetch per window batch; language detection on the first
window; SE-DiCoW's fixed 30 s enrollment window, gathered per bucket with the
rows; joint CTC rescoring from the window's CTC logits; beam search; the
no-speech skip; temperature-fallback retries (sampled greedy, seeded per
window); token timestamps (greedy: DTW over the alignment heads'
cross-attention, decoding/token_timestamps.py); int8 cross-KV. Refused as
the JAX package refuses them: token timestamps under beam search, without
``alignment_heads``, or with the int8 cache.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import ROUND_HALF_UP, Decimal
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dicow import DiCoW
from ..utils.observability import count, span
from .beam import beam_search
from .ctc_rescorer import CTCRescorer, init_ctc_state
from .generation_config import GenerationConfig
from .greedy import greedy_decode
from .token_timestamps import (alignment_slots_from_heads,
                               extract_token_timestamps)

# ---------------------------------------------------------------------------
# host helpers: a jax-free copy of ts_asr_whisper_tpu/decoding/longform.py:
# 69-274 (constants, Segment, LongformOutput, retrieve_segment,
# round_to_nearest_0_02, fix_timestamps_from_segmentation). That module
# imports jax at the top; fold this copy back once the host helpers move out.
# ---------------------------------------------------------------------------

TIME_PRECISION = 0.02
INPUT_STRIDE = 2              # conv2 stride
NUM_SEGMENT_FRAMES = 3000     # mel frames / 30 s window
EMPTY_TOKEN_ID = 220          # "Ġ" (single space) in the whisper vocab


@dataclass
class Segment:
    start: float
    end: float
    tokens: np.ndarray
    # word-level timestamps (seconds, global time) for this segment's
    # tokens when return_token_timestamps is on (reference
    # generation.py:473-475,526-527); None otherwise
    token_timestamps: Optional[np.ndarray] = None


@dataclass
class LongformOutput:
    sequences: np.ndarray                 # (B, L) padded final token ids
    segments: List[List[Segment]] = field(default_factory=list)
    # row-windows actually decoded (incl. seek rollbacks / re-decodes);
    # benchmarks normalize throughput by this, not nominal audio length
    windows_decoded: int = 0


# ---------------------------------------------------------------------------
# segment retrieval (host) — port of generation.py:415-534
# ---------------------------------------------------------------------------


def retrieve_segment(
    seek_sequence: np.ndarray,   # generated tokens for this window (no prompt)
    timestamp_begin: int,
    seek_num_frames: int,        # mel frames consumed by this window
    time_offset: float,          # seconds at window start
    token_timestamps: Optional[np.ndarray] = None,  # full extracted row
    prompt_len: int = 0,         # the reference's idx_offset
) -> tuple:
    """Split a window's decoded tokens into timestamped segments and compute
    how many mel frames to advance the seek pointer.

    With ``token_timestamps`` (the per-row DTW extraction incl. prompt
    zeros), segments carry their token-level times: the consecutive-
    timestamp branch slices ``[prompt_len + last : prompt_len + current]``
    and the no-consecutive branch attaches the FULL row — both quirks
    exactly as the reference (generation.py:473-475,526-527)."""
    seek_sequence = np.asarray(seek_sequence)
    ts_tokens = seek_sequence >= timestamp_begin
    single_timestamp_ending = (
        len(seek_sequence) >= 2 and ts_tokens[-2:].tolist() == [False, True])
    consec = np.where(ts_tokens[:-1] & ts_tokens[1:])[0] + 1

    segments: List[Segment] = []
    if len(consec) > 0:
        slices = consec.tolist()
        if single_timestamp_ending:
            slices.append(len(seek_sequence))
        else:
            slices[-1] += 1
        last_slice = 0
        for i, current_slice in enumerate(slices):
            is_last = i == len(slices) - 1
            sliced = seek_sequence[last_slice:current_slice]
            start_pos = int(sliced[0]) - timestamp_begin
            end_idx = -1 if (not is_last or single_timestamp_ending) else -2
            end_pos = int(sliced[end_idx]) - timestamp_begin
            tt = None
            if token_timestamps is not None:
                tt = token_timestamps[prompt_len + last_slice:
                                      prompt_len + current_slice] \
                    + time_offset
            segments.append(Segment(
                start=time_offset + start_pos * TIME_PRECISION,
                end=time_offset + end_pos * TIME_PRECISION,
                tokens=sliced, token_timestamps=tt))
            last_slice = current_slice
        if single_timestamp_ending:
            segment_offset = seek_num_frames
        else:
            last_ts_pos = int(seek_sequence[last_slice - 2]) - timestamp_begin
            segment_offset = last_ts_pos * INPUT_STRIDE
    else:
        timestamps = seek_sequence[ts_tokens]
        start_pos = 0.0
        last_pos = seek_num_frames // 2
        skip = False
        segment_offset = seek_num_frames
        if timestamps.size > 1:
            start_pos = int(timestamps[-2]) - timestamp_begin
            last_pos = int(timestamps[-1]) - timestamp_begin
        elif timestamps.size == 1:
            start_pos = int(timestamps[-1]) - timestamp_begin
            if start_pos > 200:
                # segment does not fit the window: roll the seek back
                # (timestamp may be inaccurate, generation.py:504-507)
                segment_offset = start_pos * INPUT_STRIDE - 100
                skip = True
        elif timestamps.size == 0 and len(seek_sequence) > 1:
            pass  # no-timestamp decoding: keep output as-is
        else:
            skip = True
        if not skip:
            tt = None
            if token_timestamps is not None:
                # reference quirk: the whole extracted row (incl. prompt
                # zeros) is attached here, not a slice (generation.py:526)
                tt = token_timestamps + time_offset
            segments = [Segment(
                start=time_offset + start_pos * TIME_PRECISION,
                end=time_offset + last_pos * TIME_PRECISION,
                tokens=seek_sequence, token_timestamps=tt)]
            segment_offset = seek_num_frames

    if segment_offset <= 0:
        raise ValueError(
            f"Segment offset {segment_offset} <= 0; this should not happen")
    return segments, int(segment_offset)


# ---------------------------------------------------------------------------
# timestamp re-blocking (host) — port of generation.py:314-413
# ---------------------------------------------------------------------------


def round_to_nearest_0_02(x: float) -> Decimal:
    d = Decimal(str(x))
    step = Decimal("0.02")
    return (d / step).to_integral_value(rounding=ROUND_HALF_UP) * step


def fix_timestamps_from_segmentation(
    all_segments: List[List[Segment]],
    timestamp_begin: int,
    pad_token_id: int,
    empty_token_id: int = EMPTY_TOKEN_ID,
) -> np.ndarray:
    """Re-linearize global-time segments into Whisper's 0-30 s timestamp
    range with dummy block bridges. Token-level equivalent of the
    reference's decode->re-encode roundtrip (generation.py:322-413): instead
    of stringifying, timestamp ids are emitted directly (text is identical)."""

    def ts_id(t: Decimal) -> int:
        return timestamp_begin + int(
            (t / Decimal("0.02")).to_integral_value(rounding=ROUND_HALF_UP))

    results = []
    for segs in all_segments:
        segs = [s for s in segs
                if len(s.tokens) > 0 and not (
                    len(s.tokens) == 1 and int(s.tokens[0]) == timestamp_begin)]
        result = []  # (start Decimal, [text tokens], end Decimal) in 0-30
        prev_end = None
        correction = Decimal(0)
        for seg in segs:
            start_time = round_to_nearest_0_02(float(seg.start))
            end_time = round_to_nearest_0_02(float(seg.end))
            tokens = [int(t) for t in seg.tokens
                      if int(t) < timestamp_begin]
            current_block = (start_time + correction) // 30
            if prev_end is not None:
                prev_block = (prev_end - Decimal("0.001")) // 30
                num_dummies = current_block - prev_block - 1
                if current_block > prev_block:
                    result.append((Decimal(30), [empty_token_id], Decimal(30)))
                for _ in range(int(num_dummies)):
                    result.append((Decimal(0), [empty_token_id], Decimal(30)))
            else:
                for _ in range(int(start_time // 30)):
                    result.append((Decimal(0), [empty_token_id], Decimal(30)))

            if (start_time + correction) // 30 == (end_time + correction) // 30:
                result.append(((start_time + correction) % 30, tokens,
                               (end_time + correction) % 30))
            elif (end_time + correction) % 30 == 0:
                result.append(((start_time + correction) % 30, tokens,
                               Decimal(30)))
                correction = Decimal(0)
            else:
                new_start = (correction + start_time) % 30
                seg_duration = end_time - start_time
                new_end = (end_time + correction) % 30
                if seg_duration == Decimal(30):
                    if float(new_start) % 30.0 == 0.0:
                        new_end = Decimal(30)
                        correction = Decimal(0)
                    else:
                        correction = Decimal("-0.02")
                        new_end += correction
                else:
                    correction = Decimal(0)
                result.append((new_start, tokens, new_end))
            prev_end = end_time + correction

        ids: List[int] = []
        for start, toks, end in result:
            ids.append(ts_id(start))
            ids.extend(toks)
            ids.append(ts_id(end))
        results.append(ids)

    max_len = max((len(r) for r in results), default=1) or 1
    out = np.full((len(results), max_len), pad_token_id, dtype=np.int64)
    for i, r in enumerate(results):
        out[i, : len(r)] = r
    return out


# ---------------------------------------------------------------------------
# fallback quality checks (host): a jax-free copy of
# ts_asr_whisper_tpu/decoding/longform.py:279-307
# ---------------------------------------------------------------------------


def compression_ratio(tokens, vocab_size: int) -> float:
    """HF WhisperGenerationMixin._retrieve_compression_ratio: zlib ratio over
    fixed-width little-endian token bytes (width = int(log2(V)/8)+1). The
    reference's fallback checks run on token bytes, not decoded text."""
    import math
    import zlib

    width = int(math.log2(vocab_size) / 8) + 1
    data = b"".join(int(t).to_bytes(width, "little") for t in tokens)
    return len(data) / len(zlib.compress(data))


def _needs_fallback(tokens, avg_logprob, gen_cfg: GenerationConfig,
                    vocab_size: int) -> bool:
    """HF generate_with_fallback quality checks (_need_fallback): high zlib
    compression ratio (repetition) or low average logprob triggers a
    re-decode at the next temperature."""
    if gen_cfg.compression_ratio_threshold is not None and len(tokens):
        if compression_ratio(tokens, vocab_size) \
                > gen_cfg.compression_ratio_threshold:
            return True
    if gen_cfg.logprob_threshold is not None \
            and avg_logprob < gen_cfg.logprob_threshold:
        return True
    return False


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def slice_windows(features: torch.Tensor, stno: torch.Tensor,
                  meta: np.ndarray, nsf: int):
    """Seek-window assembly on the device (longform.py:41-67).

    features: (B, M, T + nsf) zero-padded; stno: (B, 4, (T + nsf) // 2);
    meta: (4, bucket) [row ids; mel-frame seek offsets; valid mel frames;
    valid 50 Hz frames]. The mel tail is zeroed and the STNO tail is
    silence."""
    dev = features.device
    mel_pos = torch.arange(nsf, device=dev)
    stno_pos = torch.arange(nsf // 2, device=dev)
    windows, stno_windows = [], []
    for r, s, nm, ns in zip(*(row.tolist() for row in meta)):
        w = features[r, :, s: s + nsf]
        windows.append(torch.where(mel_pos < nm, w, 0.0))
        tail = stno_pos >= ns
        sv = torch.where(tail, 0.0, stno[r, :, s // 2: s // 2 + nsf // 2])
        sv[0] = torch.where(tail, 1.0, sv[0])
        stno_windows.append(sv)
    return torch.stack(windows), torch.stack(stno_windows)


@torch.no_grad()
def detect_language(model: DiCoW, gen_cfg: GenerationConfig,
                    encoder_hidden: torch.Tensor) -> np.ndarray:
    """One decoder step from <sot>; argmax restricted to the language
    tokens (longform.py:310-334)."""
    b = encoder_hidden.shape[0]
    dev = encoder_hidden.device
    sot = torch.full((b, 1), gen_cfg.decoder_start_token_id,
                     dtype=torch.long, device=dev)
    dec = model.decoder
    logits = dec.lm_logits(dec(sot, encoder_hidden)[:, -1])
    ids = torch.tensor(gen_cfg.lang_ids, dtype=torch.long, device=dev)
    return ids[logits[:, ids].argmax(dim=-1)].cpu().numpy()


def check_scope(gen_cfg: GenerationConfig) -> None:
    """Refuse what the JAX package refuses (longform.py:379-395,
    whisper.py:542-543): token timestamps under beam search, without
    alignment heads, or over the int8 cross-KV cache."""
    if not gen_cfg.return_token_timestamps:
        return
    if gen_cfg.num_beams > 1:
        raise NotImplementedError(
            "return_token_timestamps is implemented for the greedy path"
            " (num_beams == 1); see decoding/token_timestamps.py")
    if not gen_cfg.alignment_heads:
        raise ValueError(
            "return_token_timestamps needs generation-config "
            "alignment_heads (HF raises the same requirement)")
    if gen_cfg.cross_kv_quant:
        raise ValueError(
            "alignment collection needs the exact cross-KV cache")


def _fetch(out, lp_value: torch.Tensor, rows: np.ndarray):
    """ONE device->host transfer of a decode's token ids and fp32 scores
    (exact in float64), and a second for the alignment weights when the
    decode collected them. Yields (batch row, sequence, length, logprob
    value, no-speech prob, weights or None) for the first occurrence of each
    batch row of the bucket (padded duplicates are ignored)."""
    seq_len = out.sequences.shape[1]
    fetched = torch.cat([
        out.sequences.double(), out.lengths[:, None].double(),
        lp_value[:, None].double(),
        out.no_speech_probs[:, None].double()], dim=1).cpu().numpy()
    weights = getattr(out, "alignment_weights", None)
    if weights is not None:
        weights = weights.cpu().numpy()
    seen = set()
    for j, i in enumerate(rows):
        if i in seen:
            continue
        seen.add(i)
        yield (i, fetched[j, :seq_len].astype(np.int64),
               int(fetched[j, seq_len]), fetched[j, seq_len + 1],
               fetched[j, seq_len + 2],
               None if weights is None else weights[j])


def _next_pow2(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


@torch.no_grad()
def longform_generate(
    model: DiCoW,
    gen_cfg: GenerationConfig,
    input_features: np.ndarray,     # (B, n_mels, T_total) host array
    stno_mask: np.ndarray,          # (B, 4, T_total // 2)
    attention_mask: np.ndarray,     # (B, T_total) mel-frame validity
    forced_decoder_ids: np.ndarray,  # (B, P) decoder prompts
    enroll_features: Optional[np.ndarray] = None,  # (B, n_mels, 3000)
    enroll_stno: Optional[np.ndarray] = None,      # (B, 4, 1500)
    return_segments: bool = False,
    detect_lang: bool = False,      # fill forced_decoder_ids[:, 1]
    upper_to_lower: Optional[np.ndarray] = None,  # (2, n) CTC case-fold map
    token_ts_num_frames: Optional[np.ndarray] = None,  # (B,) valid mel
    # frames for the token-timestamp DTW crop (HF's num_frames; None = no
    # crop)
) -> LongformOutput:
    """Batched long-form transcription on the model's device. Returns a
    LongformOutput whose ``sequences`` carry re-blocked 0-30 s timestamps
    (ready for the SegLST parser); with ``gen_cfg.return_token_timestamps``
    its segments carry per-token times."""
    with span("decode.longform"):
        return _seek_loop(
            model, gen_cfg, input_features, stno_mask, attention_mask,
            forced_decoder_ids, enroll_features, enroll_stno,
            return_segments, detect_lang, upper_to_lower,
            token_ts_num_frames)


def _seek_loop(model, gen_cfg, input_features, stno_mask, attention_mask,
               forced_decoder_ids, enroll_features, enroll_stno,
               return_segments, detect_lang, upper_to_lower,
               token_ts_num_frames) -> LongformOutput:
    check_scope(gen_cfg)
    cfg = model.cfg
    dev = next(model.parameters()).device
    b, _, t_total = input_features.shape
    nsf = cfg.max_source_positions * INPUT_STRIDE
    max_frames = np.asarray(attention_mask).sum(-1).astype(np.int64)
    seek = np.zeros(b, dtype=np.int64)
    prompt_len = forced_decoder_ids.shape[1]
    max_new = gen_cfg.max_length - prompt_len
    all_segments: List[List[Segment]] = [[] for _ in range(b)]
    ts_begin = gen_cfg.timestamp_begin
    temps = tuple(gen_cfg.temperature or (0.0,))
    fallback = len(temps) > 1 and (
        gen_cfg.logprob_threshold is not None
        or gen_cfg.compression_ratio_threshold is not None)
    alignment_slots = None
    if gen_cfg.return_token_timestamps:
        alignment_slots = torch.as_tensor(alignment_slots_from_heads(
            gen_cfg.alignment_heads, cfg.decoder_layers,
            cfg.decoder_attention_heads), device=dev)

    with span("seek.upload"):
        # full recordings on the device for the whole call, zero-padded by
        # one window so that every seek slice is in bounds
        feats_dev = F.pad(torch.as_tensor(input_features,
                                          dtype=torch.float32),
                          (0, nsf)).to(dev)
        stno_dev = F.pad(torch.as_tensor(stno_mask, dtype=torch.float32),
                         (0, nsf // 2)).to(dev)
        # SE-DiCoW: the same enrollment window rides every seek window of
        # its row (longform.py:422-425, 482-490)
        enroll = ()
        if enroll_features is not None:
            enroll = tuple(torch.as_tensor(x, dtype=torch.float32).to(dev)
                           for x in (enroll_features, enroll_stno))

    if detect_lang and gen_cfg.lang_ids:
        meta0 = np.stack([
            np.arange(b),
            np.zeros(b, np.int64),
            np.full(b, min(t_total, nsf)),
            np.clip(max_frames // 2, 0, nsf // 2),
        ])
        first, first_stno = slice_windows(feats_dev, stno_dev, meta0, nsf)
        langs = detect_language(model, gen_cfg,
                                model.encoder(first, first_stno, *enroll))
        forced_decoder_ids = np.asarray(forced_decoder_ids).copy()
        forced_decoder_ids[:, 1] = langs

    with span("seek.upload"):
        forced_dev = torch.as_tensor(np.asarray(forced_decoder_ids),
                                     dtype=torch.long).to(dev)

    windows_decoded = 0
    while (seek < max_frames).any():
        with span("seek.slice"):
            active_idx = np.where(seek < max_frames)[0]
            windows_decoded += len(active_idx)
            bucket = _next_pow2(len(active_idx), b)
            rows = np.concatenate(
                [active_idx, np.full(bucket - len(active_idx),
                                     active_idx[0], np.int64)])
            active = np.zeros(b, dtype=bool)
            active[active_idx] = True

            seek_num_frames = np.maximum(
                np.minimum(max_frames - seek, nsf), 0)
            seek_rows = seek[rows]
            n_stno = np.clip(max_frames[rows] // 2 - seek_rows // 2, 0,
                             nsf // 2)
            meta = np.stack([rows, seek_rows, seek_num_frames[rows],
                             n_stno])
            window, stno_window = slice_windows(feats_dev, stno_dev, meta,
                                                nsf)
            rows_dev = torch.as_tensor(rows, device=dev)
            forced_rows = forced_dev[rows_dev]
            enroll_rows = tuple(x[rows_dev] for x in enroll)
        count("seek.bucket_rows", bucket)
        count("seek.active_rows", len(active_idx))

        with span("seek.encoder"):
            enc = model.encoder(window, stno_window, *enroll_rows)

        ctc_scorer = ctc_state = None
        if gen_cfg.ctc_weight > 0:
            blank = cfg.ctc_vocab_size - 1
            ctc_scorer = CTCRescorer(
                blank_id=blank, eos_id=gen_cfg.eos_token_id,
                timestamp_begin=ts_begin, ctc_weight=gen_cfg.ctc_weight,
                k=min(500, ts_begin - 1), prefix_len=prompt_len,
                debug=gen_cfg.joint_debug)
            enc_logits = model.encoder.ctc_logits(enc)
            ctc_state = init_ctc_state(
                enc_logits, blank, upper_to_lower,
                num_beams=max(gen_cfg.num_beams, 1), k=ctc_scorer.k,
                p_bf16=gen_cfg.ctc_p_bf16, psi_impl=gen_cfg.ctc_psi_impl)
        with span("seek.decode"):
            if gen_cfg.num_beams > 1:
                out = beam_search(model, gen_cfg, enc, forced_rows,
                                  max_new, gen_cfg.num_beams, ctc_scorer,
                                  ctc_state)
                # beam: the length-penalized score is the logprob value
                # (longform.py:562-571, HF _need_fallback's beam branch)
                lp_value = out.scores
            else:
                out = greedy_decode(model, gen_cfg, enc, forced_rows,
                                    max_new, ctc_scorer=ctc_scorer,
                                    ctc_state=ctc_state,
                                    alignment_slots=alignment_slots)
                lp_value = out.sum_logprobs

        with span("seek.fetch"):
            sequences = np.zeros((b, out.sequences.shape[1]),
                                 dtype=np.int64)
            lengths = np.zeros(b, dtype=np.int64)
            lp_values = np.zeros(b, dtype=np.float64)
            no_speech = np.zeros(b, dtype=np.float64)
            weights = None
            if alignment_slots is not None:
                weights = np.zeros(
                    (b, *out.alignment_weights.shape[1:]), np.float32)
            for i, seq, n, lp, ns, w in _fetch(out, lp_value, rows):
                sequences[i], lengths[i], lp_values[i], no_speech[i] = \
                    seq, n, lp, ns
                if w is not None:
                    weights[i] = w
            if gen_cfg.num_beams > 1:
                avg_lp = lp_values
            else:
                avg_lp = lp_values / np.maximum(lengths - prompt_len, 1)

        def skip_mask() -> np.ndarray:
            # no-speech skip (HF _need_fallback): silence iff the SOT-step
            # no-speech prob exceeds its threshold AND the decode is
            # low-confidence; both thresholds must be set
            if (gen_cfg.no_speech_threshold is None
                    or gen_cfg.logprob_threshold is None):
                return np.zeros(b, dtype=bool)
            return ((no_speech > gen_cfg.no_speech_threshold)
                    & (avg_lp < gen_cfg.logprob_threshold))

        # temperature fallback (longform.py:573-641, HF
        # generate_with_fallback): rows failing the quality checks re-decode
        # at the next temperature, greedy (HF forces one beam for sampling)
        # even after a beam first pass; the whole bucket re-runs and only
        # the failing rows take the retry's result. Rows under the
        # no-speech skip never fall back.
        if fallback:
            ctc_state_retry = ctc_state
            if ctc_scorer is not None and gen_cfg.num_beams > 1:
                # retries are single-hypothesis: a fresh per-row CTC state
                ctc_state_retry = init_ctc_state(
                    enc_logits, blank, upper_to_lower, num_beams=1,
                    k=ctc_scorer.k)
            for t_i, temp in enumerate(temps[1:], start=1):
                with span("seek.segments"):
                    skip_now = skip_mask()
                    needs = np.zeros(b, dtype=bool)
                    for i in np.unique(rows):
                        if skip_now[i]:
                            continue
                        needs[i] = _needs_fallback(
                            sequences[i, prompt_len: int(lengths[i])],
                            avg_lp[i], gen_cfg, cfg.vocab_size)
                if not needs.any():
                    break
                with span("seek.decode"):
                    gen = torch.Generator(device=dev).manual_seed(
                        int(seek.sum()) + t_i)
                    retry = greedy_decode(
                        model, gen_cfg, enc, forced_rows, max_new,
                        ctc_scorer=ctc_scorer, ctc_state=ctc_state_retry,
                        temperature=float(temp), generator=gen,
                        alignment_slots=alignment_slots)
                with span("seek.fetch"):
                    for i, seq, n, lp, ns, w in _fetch(
                            retry, retry.sum_logprobs, rows):
                        if not needs[i]:
                            continue
                        sequences[i], lengths[i], no_speech[i] = \
                            seq, n, ns
                        # fp32 sum over an int, as the JAX package
                        # divides
                        avg_lp[i] = (np.float32(lp)
                                     / max(n - prompt_len, 1))
                        if w is not None:
                            weights[i] = w

        with span("seek.segments"):
            skip_silence = skip_mask()

            token_ts = None
            if weights is not None:
                # HF extracts per seek window over the active rows,
                # with num_frames = the caller's num_frames - seek
                act = np.where(active)[0]
                nf = None
                if token_ts_num_frames is not None:
                    nf = (np.asarray(token_ts_num_frames, np.int64)
                          - seek)[act]
                ts_rows = extract_token_timestamps(
                    weights[act], prompt_len, lengths[act],
                    num_frames=nf,
                    median_filter_width=gen_cfg.median_filter_width)
                token_ts = {int(i): ts_rows[k]
                            for k, i in enumerate(act)}

            for i in range(b):
                if not active[i]:
                    continue
                if skip_silence[i]:
                    seek[i] += int(seek_num_frames[i])
                    continue
                seq = sequences[i, prompt_len: lengths[i]]
                # strip trailing eos/pad
                while len(seq) and seq[-1] in (gen_cfg.eos_token_id,
                                               gen_cfg.pad_token_id):
                    seq = seq[:-1]
                time_offset = (float(seek[i]) * TIME_PRECISION
                               / INPUT_STRIDE)
                segments, offset = retrieve_segment(
                    seq, ts_begin, int(seek_num_frames[i]), time_offset,
                    token_timestamps=(token_ts[i] if token_ts is not None
                                      else None),
                    prompt_len=prompt_len)
                all_segments[i].extend(segments)
                seek[i] += offset

    sequences = fix_timestamps_from_segmentation(
        all_segments, ts_begin, gen_cfg.pad_token_id)
    return LongformOutput(sequences=sequences,
                          segments=all_segments if return_segments else [],
                          windows_decoded=windows_decoded)
