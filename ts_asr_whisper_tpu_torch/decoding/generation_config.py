"""Generation configuration — static (hashable) so it can parameterize jitted
decode loops. Mirrors the fields of the reference's generation_config.json
(the reference's export_sources/generation_config.json) + the knobs set by
update_generation_config (reference src/utils/general.py:19-37)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 448
    max_new_tokens: Optional[int] = None
    num_beams: int = 1
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257
    pad_token_id: int = 50257
    bos_token_id: int = 50257
    no_timestamps_token_id: int = 50364
    prev_sot_token_id: int = 50362
    suppress_tokens: Tuple[int, ...] = ()
    begin_suppress_tokens: Tuple[int, ...] = ()
    return_timestamps: bool = True
    max_initial_timestamp_index: Optional[int] = None
    ctc_weight: float = 0.0
    ctc_margin: int = 0
    length_penalty: float = 1.0
    repetition_penalty: Optional[float] = None
    no_speech_threshold: Optional[float] = None
    logprob_threshold: Optional[float] = None
    compression_ratio_threshold: Optional[float] = None
    temperature: Tuple[float, ...] = (0.0,)
    task_to_id: Tuple[Tuple[str, int], ...] = (("transcribe", 50360),
                                               ("translate", 50359))
    lang_ids: Tuple[int, ...] = ()      # sorted ids of language tokens
    is_multilingual: bool = True
    early_stopping: bool = False
    # serving optimization: int8 cross-KV cache (halves the dominant HBM
    # read of each decode step; lossy — off for parity-exact decoding)
    cross_kv_quant: bool = False
    # serving optimization: bf16 CTC posterior for the beam psi matmul
    # (halves the rescorer's ~2.5 GB/batch-8 p_tv tensor; accumulation
    # stays fp32 — see decoding/ctc_rescorer.py::init_ctc_state)
    ctc_p_bf16: bool = False
    # beam-mode psi strategy: 'auto' = candidate-restricted DMA-gather on
    # TPU / full-vocab matmul elsewhere; 'matmul' / 'gather' force one
    # (decoding/ctc_rescorer.py::resolve_psi_impl, ops/psi_gather.py)
    ctc_psi_impl: str = "auto"
    # per-step top-k att/CTC/fused debug dump during joint decoding
    # (reference analyze_predictions, decoding.py:214-266)
    joint_debug: bool = False
    # word-level token timestamps (DTW over cross-attention alignment
    # heads; greedy path only — decoding/token_timestamps.py). Mirrors
    # HF/reference return_token_timestamps + generation_config
    # alignment_heads/median_filter_width
    # (reference generation.py:427-436,473-475,526-527)
    return_token_timestamps: bool = False
    alignment_heads: Tuple[Tuple[int, int], ...] = ()
    median_filter_width: int = 7

    @property
    def timestamp_begin(self) -> int:
        return self.no_timestamps_token_id + 1

    @classmethod
    def from_json(cls, path: str, **overrides) -> "GenerationConfig":
        with open(path) as f:
            raw = json.load(f)
        kw = {}
        for f_ in ("max_length", "num_beams", "decoder_start_token_id",
                   "eos_token_id", "pad_token_id", "bos_token_id",
                   "no_timestamps_token_id", "prev_sot_token_id",
                   "return_timestamps", "max_initial_timestamp_index",
                   "ctc_weight", "ctc_margin", "is_multilingual",
                   "no_speech_threshold", "logprob_threshold",
                   "compression_ratio_threshold"):
            if raw.get(f_) is not None:
                kw[f_] = raw[f_]
        if raw.get("temperature") is not None:
            t = raw["temperature"]
            kw["temperature"] = tuple(t) if isinstance(t, (list, tuple)) \
                else (t,)
        if raw.get("suppress_tokens"):
            kw["suppress_tokens"] = tuple(raw["suppress_tokens"])
        if raw.get("begin_suppress_tokens"):
            kw["begin_suppress_tokens"] = tuple(raw["begin_suppress_tokens"])
        if raw.get("lang_to_id"):
            kw["lang_ids"] = tuple(sorted(raw["lang_to_id"].values()))
        if raw.get("task_to_id"):
            kw["task_to_id"] = tuple(sorted(raw["task_to_id"].items()))
        if raw.get("alignment_heads"):
            kw["alignment_heads"] = tuple(
                (int(l_), int(h)) for l_, h in raw["alignment_heads"])
        if raw.get("median_filter_width") is not None:
            kw["median_filter_width"] = int(raw["median_filter_width"])
        kw.update(overrides)
        return cls(**kw)
