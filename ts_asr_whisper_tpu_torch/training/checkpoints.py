"""Checkpoints of the port: ``torch.save`` train state and the HF
safetensors export.

Counterpart of ts_asr_whisper_tpu/training/checkpoints.py:26-93 with
``torch.save``/``torch.load`` in place of Orbax, and the same layout:
``<directory>/step_<n>/`` per checkpoint, ``<directory>/latest`` naming the
newest step, older ones pruned to ``keep``. The export writes
``model.safetensors`` under the keys the JAX package's ``params_to_hf``
writes (the ``DiCoW`` module's ``state_dict`` names, ``proj_out.weight``
included), plus ``config.json`` and ``generation_config.json``. Under data
parallelism ``save_model_checkpoint`` writes the whole model once, from
rank 0.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import DiCoWConfig
from ..parallel import dist as pdist
from ..parallel.mesh import full_state_dict
from ..utils.logging_def import get_logger

logger = get_logger(__name__)

STATE_FILE = "state.pt"
HF_CONFIG_KEYS = (
    "vocab_size", "num_mel_bins", "d_model", "encoder_layers",
    "decoder_layers", "encoder_attention_heads", "decoder_attention_heads",
    "encoder_ffn_dim", "decoder_ffn_dim", "max_source_positions",
    "max_target_positions", "decoder_start_token_id", "eos_token_id",
    "pad_token_id", "bos_token_id", "ctc_weight", "additional_layer",
    "additional_self_attention_layer", "pre_ctc_sub_sample", "use_fddt",
    "fddt_is_diagonal", "fddt_bias_only", "fddt_use_silence",
    "fddt_use_target", "fddt_use_overlap", "fddt_use_non_target",
    "remove_timestamps_from_ctc", "apply_fddt_to_n_layers", "fddt_init",
    "non_target_fddt_value", "use_enrollments", "scb_layers",
    "use_pre_pos_fddt")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(directory: str, params: Dict[str, torch.Tensor],
                    opt_state: Any = None, step: int = 0,
                    keep: int = 1) -> str:
    """``params`` (a state dict) and, when given, ``opt_state`` (nested
    dicts/lists of tensors and numbers) under directory/step_<n>; prunes
    all but the newest ``keep``."""
    directory = Path(directory).resolve()
    path = directory / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    state = {"params": _to_cpu(dict(params)), "step": step}
    if opt_state is not None:
        state["opt_state"] = _to_cpu(opt_state)
    tmp = path / f".{STATE_FILE}.tmp"
    torch.save(state, tmp)
    tmp.replace(path / STATE_FILE)
    (directory / "latest").write_text(str(step))
    ckpts = sorted(directory.glob("step_*"),
                   key=lambda p: int(p.name.split("_")[1]))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return str(path)


def save_model_checkpoint(directory: str, model: torch.nn.Module,
                          step: int = 0, keep: int = 1) -> None:
    """``save_checkpoint`` of the model's whole state dict, DDP / FSDP2
    wrapper or not: every rank calls it (FSDP2 gathers the shards), rank 0
    writes and every rank waits until it has."""
    state = full_state_dict(model)
    if pdist.is_zero_rank():
        save_checkpoint(directory, state, step=step, keep=keep)
    pdist.barrier("checkpoint")


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location: Any = "cpu") -> Tuple[dict, int]:
    """(state, step): state holds 'params' and, if saved, 'opt_state';
    the newest step unless ``step`` is given."""
    directory = Path(directory).resolve()
    if step is None:
        step = int((directory / "latest").read_text())
    state = torch.load(directory / f"step_{step}" / STATE_FILE,
                       map_location=map_location, weights_only=True)
    return state, step


def export_hf_checkpoint(params: Dict[str, torch.Tensor], cfg: DiCoWConfig,
                         out_dir: str,
                         generation_config: Optional[dict] = None) -> None:
    """Write model.safetensors (fp32) + config.json (+ the generation
    config) in the DiCoW HF layout."""
    from safetensors.numpy import save_file

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sd = {k: np.ascontiguousarray(v.detach().float().cpu().numpy())
          for k, v in params.items()}
    save_file(sd, str(out / "model.safetensors"))
    config = {"model_type": "DiCoW",
              "architectures": ["DiCoWForConditionalGeneration"],
              **{k: getattr(cfg, k) for k in HF_CONFIG_KEYS}}
    with open(out / "config.json", "w") as f:
        json.dump(config, f, indent=2)
    if generation_config:
        with open(out / "generation_config.json", "w") as f:
            json.dump(generation_config, f, indent=2)
    logger.info("Exported HF checkpoint to %s", out)
