"""Configuration system: dataclass schema + YAML group composition.

A lightweight Hydra-equivalent (Hydra/OmegaConf are not dependencies): YAML
config groups under ``ts_asr_whisper_tpu/configs/`` compose onto ``base.yaml``,
with dotted CLI overrides and ``${oc.env:VAR}`` / ``${env:VAR}`` interpolation.

Schema mirrors the reference CLI surface
(the reference's src/utils/training_args.py:55-295 and
the reference's configs/base.yaml) while replacing GPU/DDP-specific knobs with
TPU-mesh equivalents (``mesh_shape``, ``donate_params``, ...).
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, List, Optional

import yaml

CONFIG_DIR = Path(__file__).parent / "configs"

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    """Model architecture / init. Mirrors reference ModelArguments
    (training_args.py:55-103) + DiCoWConfig extras (config.py:11-59)."""

    whisper_model: str = "openai/whisper-small.en"
    ctc_weight: float = 0.0
    additional_layer: bool = False
    additional_self_attention_layer: bool = False
    pre_ctc_sub_sample: bool = False
    reinit_encoder_from: Optional[str] = None
    reinit_from: Optional[str] = None

    # FDDT params
    use_fddt: bool = True
    fddt_is_diagonal: bool = True
    fddt_bias_only: bool = False
    fddt_use_silence: bool = True
    fddt_use_target: bool = True
    fddt_use_overlap: bool = True
    fddt_use_non_target: bool = True
    apply_fddt_to_n_layers: int = -1
    fddt_init: str = "suppressive"  # random | non-disturbing | suppressive
    non_target_fddt_value: float = 1.0
    use_pre_pos_fddt: bool = True

    prefixes_to_preheat: List[str] = field(default_factory=list)
    params_to_keep_frozen_keywords: List[str] = field(default_factory=list)

    # SE-DiCoW
    use_enrollments: bool = False
    scb_layers: Optional[int] = None

    # CTC head details
    remove_timestamps_from_ctc: bool = False
    blank_token_id: Optional[int] = None
    ctc_loss_reduction: str = "mean"

    # Numerics (TPU-specific)
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "float32"   # parameter dtype
    attention_impl: str = "auto"   # auto | xla | pallas

    def __post_init__(self):
        for attr in ("reinit_encoder_from", "reinit_from"):
            v = getattr(self, attr)
            if isinstance(v, str) and "openai" in v:
                setattr(self, attr, v.replace("openai/whisper-", ""))


@dataclass
class DataConfig:
    """Mirrors reference DataArguments (training_args.py:124-175)."""

    # accepted for config-name parity; the reference declares this but never
    # reads it either (training_args.py:125 is its only occurrence there)
    use_libri: bool = False
    train_cutsets: List[str] = field(default_factory=list)
    dev_cutsets: List[str] = field(default_factory=list)
    eval_cutsets: List[str] = field(default_factory=list)
    enrollment_cutsets: List[str] = field(default_factory=list)
    merge_eval_cutsets: bool = False
    use_timestamps: bool = False
    max_timestamp_pause: float = 0.0
    train_text_norm: Optional[str] = None
    eval_text_norm: Optional[str] = None
    dataset_weights: Optional[List[int]] = None

    use_enrollments: bool = False
    min_enrollment_mix_overlap: float = 0.3
    max_enrollment_mix_overlap: float = 1.0
    number_of_mixed_speakers: int = 2

    provide_gt_lang: bool = False
    global_lang_id: Optional[str] = None

    use_diar: bool = False
    dev_diar_cutsets: List[str] = field(default_factory=list)
    eval_diar_cutsets: List[str] = field(default_factory=list)

    load_channel_zero_only: bool = False

    def __post_init__(self):
        for attr in ("train_cutsets", "dev_cutsets", "eval_cutsets",
                     "enrollment_cutsets", "dev_diar_cutsets", "eval_diar_cutsets"):
            v = getattr(self, attr)
            if isinstance(v, str):
                setattr(self, attr, [v])
            elif v is None:
                setattr(self, attr, [])


@dataclass
class AugmentationConfig:
    """Mirrors reference AugmentationArguments (training_args.py:107-121)."""

    musan_root: Optional[str] = None
    musan_augment_prob: float = 0.0
    do_augment: bool = False
    stno_gaussian_noise_var: Optional[float] = None
    stno_gaussian_noise_prob: float = 0.0
    stno_segment_augment_prob: float = 0.0
    stno_segment_change_prob: float = 0.0
    stno_min_segment_length: int = 0
    stno_max_segment_length: int = 0
    spec_aug_prob: float = 0.0


@dataclass
class DecodingConfig:
    """Mirrors reference DecodingArguments (training_args.py:179-183)."""

    decoding_ctc_weight: float = 0.0
    condition_on_prev: bool = False
    length_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    # TPU serving optimization: store the cross-attention KV cache int8
    # (halves the dominant HBM read per decode step; lossy, default off)
    cross_kv_quant: bool = False
    # TPU serving optimization: keep the beam-mode CTC posterior (p_tv,
    # a full (B, T, V) tensor — ~2.5 GB at batch-8 large-v3-turbo, on top
    # of the same-sized log-probs) in bf16; psi accumulates fp32
    ctc_p_bf16: bool = False
    # beam-mode psi strategy: 'auto' picks the candidate-restricted
    # DMA-gather on TPU and the full-vocab matmul elsewhere
    # (ops/psi_gather.py; both exact)
    ctc_psi_impl: str = "auto"
    # per-step top-k att/CTC/fused dump during joint decoding (reference
    # CTCRescorerLogitsProcessor debug, decoding.py:214-266)
    joint_decode_debug: bool = False


@dataclass
class TrainingConfig:
    """Training orchestration. Mirrors the reference's HF
    Seq2SeqTrainingArguments surface (training_args.py:12-277 +
    configs/base.yaml) with TPU-native replacements for DDP/CUDA knobs."""

    # accepted for config-name parity; like the reference (whose train()
    # runs unconditionally, train.py:238-240), mode selection is via
    # decode_only / pretrain_encoder, not this HF-inherited flag
    do_train: bool = False
    decode_only: bool = False
    pretrain_encoder: bool = False
    restart_from: str = ""
    resume_from_checkpoint: Optional[str] = None

    output_dir: str = "exp/default"
    run_name: str = "default"

    overall_batch_size: int = 64
    per_device_train_batch_size: int = 1
    per_device_eval_batch_size: int = 16
    gradient_accumulation_steps: int = 1
    auto_find_batch_size: bool = False

    learning_rate: float = 2e-6
    warmup_steps: int = 2000
    weight_decay: float = 0.0
    max_steps: int = 50000
    num_train_epochs: int = 10
    lr_scheduler_type: str = "linear"  # linear | cosine | constant
    max_grad_norm: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    adam_mu_dtype: Optional[str] = None  # e.g. 'bfloat16' halves moment memory

    bf16: bool = True
    bf16_full_eval: bool = True
    gradient_checkpointing: bool = False
    # remat policy under gradient_checkpointing: full | dots | attn
    # (models/whisper.py::set_remat_policy documents the measured trade)
    remat_policy: str = "full"

    use_custom_optimizer: bool = False
    use_fddt_only_n_epochs: int = 0
    use_fddt_only_n_steps: int = 0
    fddt_lr_multiplier: float = 1.0
    use_fddt: bool = True
    remove_timestamps_from_ctc: bool = False
    use_lora: bool = False
    use_flash_attention: bool = True  # maps to pallas attention on TPU

    early_stopping_patience: int = -1
    metric_for_best_model: Optional[str] = None
    greater_is_better: bool = False
    load_best_model_at_end: bool = False

    eval_strategy: str = "epoch"   # no | steps | epoch
    save_strategy: str = "epoch"
    eval_steps: int = 1000
    save_steps: int = 1000
    save_total_limit: int = 1
    logging_steps: int = 5
    eval_delay: int = 0

    generation_max_length: int = 445
    generation_num_beams: int = 1
    predict_with_generate: bool = True

    train_metrics_list: List[str] = field(default_factory=lambda: ["tcp_wer"])
    eval_metrics_list: List[str] = field(default_factory=lambda: ["tcp_wer"])
    compute_combined_metrics: bool = False

    dataloader_num_workers: int = 2
    dataloader_prefetch_factor: int = 2
    # "thread" overlaps featurization with the device step; "process"
    # forks real OS workers (torch-style) to scale feeding past one core
    dataloader_worker_type: str = "thread"


    seed: int = 42
    watch_grads: bool = False
    store_src: bool = False
    save_visualizations: bool = False
    report_to: Optional[Any] = None

    # TPU-native parallelism (replaces torchrun/DDP/FSDP passthrough).
    # A 'model' axis (e.g. mesh_shape=[4,2], mesh_axis_names=[data,model])
    # additionally tensor-shards attention/MLP projections Megatron-style
    # (parallel/mesh.py::param_shardings); composes with shard_params.
    mesh_shape: Optional[List[int]] = None   # None -> (n_devices,)
    mesh_axis_names: List[str] = field(default_factory=lambda: ["data"])
    shard_params: bool = False               # ZeRO-like param sharding over 'data'
    profile_dir: Optional[str] = None        # torch.profiler trace output


@dataclass
class WandbConfig:
    project: str = "whisper"


@dataclass
class Cfg:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    aug: AugmentationConfig = field(default_factory=AugmentationConfig)
    decoding: DecodingConfig = field(default_factory=DecodingConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    experiment: str = "DEFAULT"
    exp_dir: str = "exp"


# ---------------------------------------------------------------------------
# YAML composition
# ---------------------------------------------------------------------------

_ENV_RE = re.compile(r"\$\{(?:oc\.)?env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")
_REF_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_.]*)\}")


def _interp_str(s: str, root: dict) -> Any:
    def env_sub(m):
        val = os.getenv(m.group(1))
        if val is None:
            val = m.group(2) if m.group(2) is not None else ""
        return val

    s = _ENV_RE.sub(env_sub, s)

    def ref_sub(m):
        node: Any = root
        for part in m.group(1).split("."):
            if not isinstance(node, dict) or part not in node:
                return m.group(0)
            node = node[part]
        return str(node)

    prev = None
    while prev != s:
        prev = s
        s = _REF_RE.sub(ref_sub, s)
    return s


def _interp(node: Any, root: dict) -> Any:
    if isinstance(node, dict):
        return {k: _interp(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interp(v, root) for v in node]
    if isinstance(node, str):
        return _interp_str(node, root)
    return node


def deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot override non-dict node at {dotted!r}")
    node[parts[-1]] = value


def load_yaml(path: Path) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    # strip Hydra-style package directives if present
    data.pop("defaults", None)
    return data


def _load_overlay(config_dir: Path, rel: str, _seen: Optional[set] = None) -> dict:
    """Load a group overlay, recursively composing its Hydra-style
    ``defaults: [/group/name]`` parents first."""
    _seen = _seen or set()
    path = (config_dir / rel.lstrip("/")).with_suffix(".yaml")
    if path in _seen:
        raise ValueError(f"Config defaults cycle at {path}")
    _seen.add(path)
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    parents = data.pop("defaults", None) or []
    out: dict = {}
    for parent in parents:
        if isinstance(parent, str) and parent not in ("_self_",):
            out = deep_merge(out, _load_overlay(config_dir, parent, _seen))
    return deep_merge(out, data)


def compose(overrides: Optional[List[str]] = None,
            config_dir: Optional[Path] = None) -> dict:
    """Compose the raw config dict: base.yaml + ``+group=name`` overlays +
    dotted ``key=value`` overrides + interpolation."""
    config_dir = Path(config_dir or CONFIG_DIR)
    cfg = load_yaml(config_dir / "base.yaml")

    overrides = list(overrides or [])
    for ov in overrides:
        if ov.startswith("+"):
            group, _, name = ov[1:].partition("=")
            overlay_path = config_dir / group / f"{name}.yaml"
            if not overlay_path.exists():
                raise FileNotFoundError(f"No config overlay: {overlay_path}")
            cfg = deep_merge(cfg, _load_overlay(config_dir, f"{group}/{name}"))
    for ov in overrides:
        if not ov.startswith("+"):
            key, _, val = ov.partition("=")
            _set_dotted(cfg, key, _parse_value(val))

    return _interp(cfg, cfg)


def _coerce(value, ftype):
    """Coerce YAML scalars to the annotated type (PyYAML 1.1 parses '2e-6'
    and 'yes'-less booleans as strings)."""
    import typing

    origin = typing.get_origin(ftype)
    if origin is typing.Union:
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        if len(args) == 1:
            return _coerce(value, args[0])
        return value
    if ftype is float and isinstance(value, (int, str)):
        return float(value)
    if ftype is int and isinstance(value, str):
        return int(value)
    if ftype is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes")
    return value


def _build_dc(cls, data: dict):
    import typing

    hints = typing.get_type_hints(cls)
    names = {f.name for f in fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"Unknown {cls.__name__} fields: {sorted(unknown)}")
    kwargs = {}
    for f in fields(cls):
        if f.name in data:
            v = data[f.name]
            ftype = hints.get(f.name, f.type)
            if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
                v = _build_dc(ftype, v)
            else:
                v = _coerce(v, ftype)
            kwargs[f.name] = v
    return cls(**kwargs)


_GROUPS = {
    "model": ModelConfig,
    "data": DataConfig,
    "aug": AugmentationConfig,
    "decoding": DecodingConfig,
    "training": TrainingConfig,
    "wandb": WandbConfig,
}


def instantiate(cfg_dict: dict) -> Cfg:
    kwargs: dict = {}
    for name, cls in _GROUPS.items():
        kwargs[name] = _build_dc(cls, cfg_dict.get(name, {}) or {})
    for scalar in ("experiment", "exp_dir"):
        if scalar in cfg_dict:
            kwargs[scalar] = cfg_dict[scalar]
    return Cfg(**kwargs)


def process_config(cfg: Cfg, n_devices: Optional[int] = None) -> Cfg:
    """Derive per-device batch size from overall_batch_size over the mesh
    (reference semantics: training_args.py:337-345)."""
    if n_devices is None:
        n_devices = 1
    if cfg.training.overall_batch_size:
        denom = max(1, n_devices) * max(1, cfg.training.gradient_accumulation_steps)
        cfg.training.per_device_train_batch_size = max(
            1, cfg.training.overall_batch_size // denom)
    cfg.experiment = cfg.experiment.replace("openai/whisper-", "")
    cfg.training.run_name = cfg.training.run_name.replace("openai/whisper-", "")
    cfg.training.output_dir = cfg.training.output_dir.replace("openai/whisper-", "")
    return cfg


def load_config(overrides: Optional[List[str]] = None,
                config_dir: Optional[Path] = None,
                n_devices: Optional[int] = None) -> Cfg:
    return process_config(instantiate(compose(overrides, config_dir)), n_devices)
