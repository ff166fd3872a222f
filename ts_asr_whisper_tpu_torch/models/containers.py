"""Model container of the port: model config, weights and tokenizer from the
CLI config.

Counterpart of ts_asr_whisper_tpu/models/containers.py:27-119. The
architecture comes from the model directory's ``config.json`` or from a size
name; weights are a seeded random init (``torch.Generator``) with the
distributions of the JAX package's ``init_dicow``, replaced by a strict load
of the directory's ``*.safetensors`` when there are any. Nothing is fetched
from the network. ``reinit_encoder_from`` and ``reinit_from`` are the JAX
container's weight re-init loaders (containers.py:122-137). SE-DiCoW's SCB
count is ``model.scb_layers`` (containers.py:71); its SCBs load under their
HF names (``encoder.ca_enrolls.{i}.cae.*``), strictly from the model
directory or partially through the re-init loaders (containers.py:200-203).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..config import Cfg
from ..data.tokenizer import (
    ByteLevelTokenizer,
    create_lower_uppercase_mapping,
    load_tokenizer,
)
from ..ops.attention import resolve_attention_impl
from ..utils.logging_def import get_logger
from .config import DiCoWConfig, make_config
from .convert import load_safetensors_dir, normalize_state_dict
from .dicow import build_dicow

logger = get_logger(__name__)

_HF_KEYS = ("vocab_size", "num_mel_bins", "d_model", "encoder_layers",
            "decoder_layers", "encoder_attention_heads",
            "decoder_attention_heads", "encoder_ffn_dim", "decoder_ffn_dim",
            "max_source_positions", "max_target_positions",
            "decoder_start_token_id", "eos_token_id", "pad_token_id",
            "bos_token_id")

_TOKENIZER_FILES = ("tokenizer.json", "vocab.json", "tokenizer_config.json")


def model_config(cfg: Cfg) -> DiCoWConfig:
    """The architecture of ``cfg.model.whisper_model`` (its directory's
    ``config.json``, or a size name) with the config's DiCoW settings; the
    container then aligns its special-token ids with the tokenizer."""
    m = cfg.model
    overrides = dict(
        ctc_weight=m.ctc_weight,
        additional_layer=m.additional_layer,
        additional_self_attention_layer=m.additional_self_attention_layer,
        pre_ctc_sub_sample=m.pre_ctc_sub_sample,
        use_fddt=m.use_fddt and cfg.training.use_fddt,
        fddt_is_diagonal=m.fddt_is_diagonal,
        fddt_bias_only=m.fddt_bias_only,
        fddt_use_silence=m.fddt_use_silence,
        fddt_use_target=m.fddt_use_target,
        fddt_use_overlap=m.fddt_use_overlap,
        fddt_use_non_target=m.fddt_use_non_target,
        apply_fddt_to_n_layers=m.apply_fddt_to_n_layers,
        fddt_init=m.fddt_init,
        non_target_fddt_value=m.non_target_fddt_value,
        use_pre_pos_fddt=m.use_pre_pos_fddt,
        remove_timestamps_from_ctc=cfg.training.remove_timestamps_from_ctc,
        use_enrollments=m.use_enrollments or cfg.data.use_enrollments,
        scb_layers=m.scb_layers,
        dtype=m.dtype,
        param_dtype=m.param_dtype,
        attention_impl=m.attention_impl,
    )

    local_dir = Path(m.whisper_model)
    if (local_dir / "config.json").exists():
        with open(local_dir / "config.json") as f:
            hf_cfg = json.load(f)
        base = {k: hf_cfg[k] for k in _HF_KEYS if k in hf_cfg}
        return DiCoWConfig(**base, **overrides)
    return make_config(m.whisper_model, **overrides)


class WhisperContainer:
    def __init__(self, cfg: Cfg, device: torch.device, seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        model_id = cfg.model.whisper_model
        self.attention_impl = resolve_attention_impl(cfg.model.attention_impl,
                                                     self.device)
        self.model_config = model_config(cfg)
        local_dir = Path(model_id) if Path(model_id).exists() else None

        # HF tokenizer files -> the HF tokenizer, else the byte-level one.
        # Asked first, transformers 5.x "loads" a directory that holds only
        # config.json as a tokenizer without vocabulary or pad token.
        tok_path = str(local_dir) if local_dir and any(
            (local_dir / f).exists() for f in _TOKENIZER_FILES) else None
        self.tokenizer = load_tokenizer(
            tok_path, vocab_size=self.model_config.vocab_size)
        if not hasattr(self.tokenizer, "upper_cased_tokens"):
            self.tokenizer.upper_cased_tokens = create_lower_uppercase_mapping(
                self.tokenizer)
        # the byte-level fallback tokenizer derives its special-token ids
        # from vocab_size; keep the model config consistent with it
        if isinstance(self.tokenizer, ByteLevelTokenizer):
            tok = self.tokenizer
            self.model_config = self.model_config.replace(
                decoder_start_token_id=tok.decoder_start_token_id,
                eos_token_id=tok.eos_token_id,
                pad_token_id=tok.pad_token_id,
                bos_token_id=tok.bos_token_id)

        self.model = build_dicow(self.model_config, self.device, seed=seed,
                                 flash=self.attention_impl == "flash",
                                 dtype=self.model_config.storage_dtype)
        if local_dir and list(local_dir.glob("*.safetensors")):
            logger.info("Loading weights from %s", local_dir)
            sd = normalize_state_dict(load_safetensors_dir(str(local_dir)))
            self.model.load_state_dict(sd, strict=True)

    # -- reference loaders (train.py:102-125) -----------------------------
    def reinit_encoder_from(self, path: str) -> None:
        """Encoder weights from a safetensors file or directory, FDDT keys
        filtered out. A dict without decoder keys is encoder-only: its keys
        may lack the ``model.`` and ``encoder.`` prefixes."""
        sd = load_safetensors_dir(path)
        sd = {k: v for k, v in sd.items() if "fddt" not in k.lower()}
        if any(k.startswith(("decoder.", "model.decoder.")) for k in sd):
            sd = normalize_state_dict(sd)
        else:
            clean = {}
            for k, v in sd.items():
                k = k.removeprefix("model.")
                if not k.startswith("encoder."):
                    k = "encoder." + k
                clean["model." + k] = v
            sd = clean
        self._load_partial(sd, path)

    def reinit_from(self, path: str) -> None:
        self._load_partial(normalize_state_dict(load_safetensors_dir(path)),
                           path)

    def _load_partial(self, sd, path: str) -> None:
        """Overlay the tensors of ``sd`` onto the model; parameters it lacks
        keep their init (freshly initialized FDDTs), keys the model lacks
        are ignored."""
        own = self.model.state_dict()
        hits = {k: v for k, v in sd.items() if k in own}
        if not hits:
            raise ValueError(f"{path}: no tensor matches the model's keys")
        self.model.load_state_dict(hits, strict=False)
        logger.info("Re-initialized %d tensors from %s", len(hits), path)
