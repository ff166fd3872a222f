"""Model configuration of the port.

Copy of ts_asr_whisper_tpu/models/config.py:10-161 (``DiCoWConfig``,
``WHISPER_SIZES``, ``make_config``) without jax: the dtype table holds torch
dtypes instead of ``jnp`` ones. Folded back once the JAX package's config no
longer imports jax (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class DiCoWConfig:
    # --- Whisper core (HF WhisperConfig names) ---
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    activation_function: str = "gelu"
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257
    pad_token_id: int = 50257
    bos_token_id: int = 50257

    # --- DiCoW extras (config.py:11-59) ---
    ctc_weight: float = 0.0
    final_dropout: float = 0.0
    blank_token_id: Optional[int] = None
    additional_layer: bool = False
    additional_self_attention_layer: bool = False
    pre_ctc_sub_sample: bool = False
    use_fddt: bool = True
    fddt_is_diagonal: bool = True
    fddt_bias_only: bool = False
    fddt_use_silence: bool = True
    fddt_use_target: bool = True
    fddt_use_overlap: bool = True
    fddt_use_non_target: bool = True
    remove_timestamps_from_ctc: bool = False
    apply_fddt_to_n_layers: int = -1
    fddt_init: str = "suppressive"
    non_target_fddt_value: float = 0.0
    use_enrollments: bool = False
    scb_layers: Optional[int] = None
    use_pre_pos_fddt: bool = False
    ctc_loss_reduction: str = "mean"

    # --- numerics / TPU ---
    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"  # storage dtype
    attention_impl: str = "xla"   # xla | pallas

    # --- derived helpers ---
    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def num_fddts(self) -> int:
        if not self.use_fddt:
            return 0
        n = self.apply_fddt_to_n_layers
        return self.encoder_layers if n == -1 else n

    @property
    def first_task_token(self) -> int:
        # 30 s of 50 Hz timestamps, -1 to reach 0.00, -6 task tokens
        # (reference: encoder.py:76)
        return self.vocab_size - 30 * 50 - 1 - 6

    @property
    def timestamp_begin(self) -> int:
        # token id of <|0.00|>
        return self.vocab_size - 30 * 50 - 1

    @property
    def no_timestamps_token_id(self) -> int:
        return self.timestamp_begin - 1

    @property
    def ctc_vocab_size(self) -> int:
        return self.vocab_size + 1  # + blank (last)

    @property
    def ctc_blank_id(self) -> int:
        return self.vocab_size if self.blank_token_id is None else self.blank_token_id

    @property
    def compute_dtype(self):
        return _DTYPES[self.dtype]

    @property
    def storage_dtype(self):
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "DiCoWConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_hf_config(cls, hf_config, **overrides) -> "DiCoWConfig":
        """Build from a transformers WhisperConfig / DiCoWConfig instance."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for name in names:
            if hasattr(hf_config, name):
                kw[name] = getattr(hf_config, name)
        kw.update(overrides)
        return cls(**kw)


# Canonical model sizes (HF whisper configs), so tests and the CLI can build
# models without the hub.
WHISPER_SIZES = {
    "tiny": dict(d_model=384, encoder_layers=4, decoder_layers=4,
                 encoder_attention_heads=6, decoder_attention_heads=6,
                 encoder_ffn_dim=1536, decoder_ffn_dim=1536,
                 num_mel_bins=80, vocab_size=51865),
    "base": dict(d_model=512, encoder_layers=6, decoder_layers=6,
                 encoder_attention_heads=8, decoder_attention_heads=8,
                 encoder_ffn_dim=2048, decoder_ffn_dim=2048,
                 num_mel_bins=80, vocab_size=51865),
    "small": dict(d_model=768, encoder_layers=12, decoder_layers=12,
                  encoder_attention_heads=12, decoder_attention_heads=12,
                  encoder_ffn_dim=3072, decoder_ffn_dim=3072,
                  num_mel_bins=80, vocab_size=51865),
    "medium": dict(d_model=1024, encoder_layers=24, decoder_layers=24,
                   encoder_attention_heads=16, decoder_attention_heads=16,
                   encoder_ffn_dim=4096, decoder_ffn_dim=4096,
                   num_mel_bins=80, vocab_size=51865),
    "large-v3": dict(d_model=1280, encoder_layers=32, decoder_layers=32,
                     encoder_attention_heads=20, decoder_attention_heads=20,
                     encoder_ffn_dim=5120, decoder_ffn_dim=5120,
                     num_mel_bins=128, vocab_size=51866),
    "large-v3-turbo": dict(d_model=1280, encoder_layers=32, decoder_layers=4,
                           encoder_attention_heads=20, decoder_attention_heads=20,
                           encoder_ffn_dim=5120, decoder_ffn_dim=5120,
                           num_mel_bins=128, vocab_size=51866),
}


def make_config(size: str = "tiny", **overrides) -> DiCoWConfig:
    name = size.replace("openai/whisper-", "")
    if name not in WHISPER_SIZES:
        raise ValueError(f"Unknown whisper size {size!r}; known: {list(WHISPER_SIZES)}")
    kw = dict(WHISPER_SIZES[name])
    kw.update(overrides)
    return DiCoWConfig(**kw)
